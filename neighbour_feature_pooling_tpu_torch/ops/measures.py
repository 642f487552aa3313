"""Similarity / distance measure registry for Neighborhood Feature Pooling.

Counterpart of ``neighbour_feature_pooling_tpu/ops/measures.py``. Every
measure compares a *center* feature vector with a *neighbor* feature vector
along the channel dimension and reduces it to one scalar per spatial
position and neighbor. Each function below is written term for term from
the JAX one, so the plain NFP version (``neighborhood.nfp_reference``) and
the CUDA kernels (``csrc/nfp_measures.cuh``) compute the same arithmetic.

Conventions: *distance* measures (``norm``, ``rmse``, ``emd``,
``canberra``, ``hellinger``, ``chisquared1/2``, ``jeffrey``,
``squaredchord``, ``mahalanobis``) are negated when ``similarity=True``;
*similarity* measures are returned as-is then, and with
``similarity=False`` are negated (``dot``, ``attention``, ``gfc``,
``pearson``, ``smith``) or flipped as ``1 - x`` (``cosine``, ``geman``,
``scs``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from .common import safe_sqrt

__all__ = [
    "MeasureConfig",
    "Measure",
    "MEASURES",
    "get_measure",
    "canonical_measure_name",
    "MEASURE_NAMES",
    "SeparableMeasure",
    "SEPARABLE",
    "get_separable",
]


def _abs(x: torch.Tensor) -> torch.Tensor:
    """``|x|`` with JAX's subgradient at 0: ``jax.grad(jnp.abs)(0.0)`` is
    1, where ``torch.abs``'s is 0. Forward values are ``torch.abs``'s."""
    return torch.where(x >= 0, x, -x)


@dataclasses.dataclass(frozen=True)
class MeasureConfig:
    """Static hyper-parameters threaded through measure evaluation:
    ``eps`` the stability constant, ``p`` the norm order / SCS sharpening
    exponent, ``q_scs`` the SCS denominator stabilizer, ``inv_var`` the
    per-channel inverse variance of ``mahalanobis`` (broadcastable against
    the operands)."""

    eps: float = 1e-6
    p: float = 1.0
    q_scs: float = 1e-6
    inv_var: Optional[torch.Tensor] = None


# --------------------------------------------------------------------------
# Pairwise kernels: (center, neighbor, dim, cfg) -> reduced-over-dim tensor.
# --------------------------------------------------------------------------


def _norm(c, n, dim, cfg):
    """L-p norm of (center - neighbor) over channels."""
    d = c - n
    p = cfg.p
    if p == 1:
        return torch.sum(_abs(d), dim=dim)
    if p == 2:
        return safe_sqrt(torch.sum(d * d, dim=dim))
    return torch.sum(_abs(d) ** p, dim=dim) ** (1.0 / p)


def _cosine(c, n, dim, cfg):
    """Cosine similarity; each L2 norm is clamped from below at ``eps``
    separately (not ``F.cosine_similarity``, which clamps the product)."""
    dot = torch.sum(c * n, dim=dim)
    nc = safe_sqrt(torch.sum(c * c, dim=dim))
    nn_ = safe_sqrt(torch.sum(n * n, dim=dim))
    return dot / (torch.clamp(nc, min=cfg.eps) * torch.clamp(nn_, min=cfg.eps))


def _dot(c, n, dim, cfg):
    return torch.sum(c * n, dim=dim)


def _rmse(c, n, dim, cfg):
    d = c - n
    return safe_sqrt(torch.mean(d * d, dim=dim))


def _geman(c, n, dim, cfg):
    """Geman–McClure robust measure, mean over channels."""
    d2 = (c - n) ** 2
    return torch.mean(d2 / (d2 + cfg.eps), dim=dim)


def _emd(c, n, dim, cfg):
    """Simplified Earth Mover's Distance = L1."""
    return torch.sum(_abs(c - n), dim=dim)


def _canberra(c, n, dim, cfg):
    return torch.sum(_abs(c - n) / (_abs(c) + _abs(n) + cfg.eps),
                     dim=dim)


def _hellinger(c, n, dim, cfg):
    """Hellinger distance on |x|+eps surrogates."""
    a = torch.sqrt(_abs(c) + cfg.eps)
    b = torch.sqrt(_abs(n) + cfg.eps)
    return safe_sqrt(0.5 * torch.sum((a - b) ** 2, dim=dim))


def _chisquared1(c, n, dim, cfg):
    """Chi-squared distance, symmetric denominator."""
    return torch.sum((c - n) ** 2 / (_abs(c) + _abs(n) + cfg.eps),
                     dim=dim)


def _chisquared2(c, n, dim, cfg):
    """Chi-squared distance, center-only denominator."""
    return torch.sum((c - n) ** 2 / (_abs(c) + cfg.eps), dim=dim)


def _gfc(c, n, dim, cfg):
    """Goodness-of-Fit Coefficient: dot / (||c||·||n|| + eps)."""
    num = torch.sum(c * n, dim=dim)
    den = (safe_sqrt(torch.sum(c * c, dim=dim))
           * safe_sqrt(torch.sum(n * n, dim=dim)))
    return num / (den + cfg.eps)


def _pearson(c, n, dim, cfg):
    """Pearson correlation over channels, centred two-pass form."""
    cc = c - torch.mean(c, dim=dim, keepdim=True)
    nc = n - torch.mean(n, dim=dim, keepdim=True)
    num = torch.sum(cc * nc, dim=dim)
    den = torch.sqrt(torch.sum(cc * cc, dim=dim) * torch.sum(nc * nc, dim=dim)
                     + cfg.eps)
    return num / den


def _jeffrey(c, n, dim, cfg):
    """Jeffrey (symmetric KL) divergence on |x|+eps surrogates."""
    a = _abs(c) + cfg.eps
    b = _abs(n) + cfg.eps
    log_ab = torch.log(a / b)
    return torch.sum(a * log_ab - b * log_ab, dim=dim)


def _squaredchord(c, n, dim, cfg):
    a = torch.sqrt(_abs(c) + cfg.eps)
    b = torch.sqrt(_abs(n) + cfg.eps)
    return torch.sum((a - b) ** 2, dim=dim)


def _smith(c, n, dim, cfg):
    """Smith dissimilarity on absolute values."""
    ca = _abs(c)
    na = _abs(n)
    min_sum = torch.sum(torch.minimum(ca, na), dim=dim)
    denom = torch.minimum(torch.sum(ca, dim=dim), torch.sum(na, dim=dim)) + cfg.eps
    return 1.0 - min_sum / denom


def _scs_from_cos(cos, p):
    """``sign(cos) * |cos|**p`` with NaN/Inf scrubbed to 0."""
    scs = torch.sign(cos) * torch.abs(cos) ** p
    return torch.nan_to_num(scs, nan=0.0, posinf=0.0, neginf=0.0)


def _scs(c, n, dim, cfg):
    """Sharpened cosine similarity, per-sample form, with q-stabilized
    norms: cos = <c,n> / ((||c||+q)(||n||+q))."""
    nc = safe_sqrt(torch.sum(c * c, dim=dim)) + cfg.q_scs
    nn_ = safe_sqrt(torch.sum(n * n, dim=dim)) + cfg.q_scs
    return _scs_from_cos(torch.sum(c * n, dim=dim) / (nc * nn_), cfg.p)


def _mahalanobis(c, n, dim, cfg):
    """Diagonal-covariance Mahalanobis distance."""
    if cfg.inv_var is None:
        raise ValueError(
            "mahalanobis requires cfg.inv_var (per-channel inverse variance); "
            "the nfp() entry point computes it automatically."
        )
    d = c - n
    return safe_sqrt(torch.sum(d * d * cfg.inv_var, dim=dim))


# --------------------------------------------------------------------------
# Finalization: distance/similarity sign conventions, per measure.
# --------------------------------------------------------------------------

_FINALIZE: Dict[str, Callable] = {
    "neg_if_sim": lambda x, sim: -x if sim else x,
    "neg_if_dist": lambda x, sim: x if sim else -x,
    "one_minus_if_dist": lambda x, sim: x if sim else 1.0 - x,
}


@dataclasses.dataclass(frozen=True)
class Measure:
    """A registered NFP measure.

    Attributes:
      name: canonical CLI name.
      pairwise: ``f(center, neighbor, dim, cfg)`` reducing ``dim``.
      finalize_kind: one of the ``_FINALIZE`` keys.
      needs_softmax_over_neighbors: softmax over the neighbor dimension
        before finalization (``attention``).
      is_distance: True if the raw value grows with dissimilarity.
    """

    name: str
    pairwise: Callable
    finalize_kind: str
    needs_softmax_over_neighbors: bool = False
    is_distance: bool = False

    def finalize(self, x: torch.Tensor, similarity: bool) -> torch.Tensor:
        return _FINALIZE[self.finalize_kind](x, similarity)


MEASURES: Dict[str, Measure] = {
    "norm": Measure("norm", _norm, "neg_if_sim", is_distance=True),
    "cosine": Measure("cosine", _cosine, "one_minus_if_dist"),
    "dot": Measure("dot", _dot, "neg_if_dist"),
    "rmse": Measure("rmse", _rmse, "neg_if_sim", is_distance=True),
    "geman": Measure("geman", _geman, "one_minus_if_dist"),
    "attention": Measure("attention", _dot, "neg_if_dist", needs_softmax_over_neighbors=True),
    "emd": Measure("emd", _emd, "neg_if_sim", is_distance=True),
    "canberra": Measure("canberra", _canberra, "neg_if_sim", is_distance=True),
    "hellinger": Measure("hellinger", _hellinger, "neg_if_sim", is_distance=True),
    "chisquared1": Measure("chisquared1", _chisquared1, "neg_if_sim", is_distance=True),
    "chisquared2": Measure("chisquared2", _chisquared2, "neg_if_sim", is_distance=True),
    "gfc": Measure("gfc", _gfc, "neg_if_dist"),
    "pearson": Measure("pearson", _pearson, "neg_if_dist"),
    "jeffrey": Measure("jeffrey", _jeffrey, "neg_if_sim", is_distance=True),
    "squaredchord": Measure("squaredchord", _squaredchord, "neg_if_sim", is_distance=True),
    "smith": Measure("smith", _smith, "neg_if_dist"),
    "scs": Measure("scs", _scs, "one_minus_if_dist"),
    "mahalanobis": Measure("mahalanobis", _mahalanobis, "neg_if_sim", is_distance=True),
}

_ALIASES = {"sharpened_cosine": "scs"}

#: Canonical CLI names, in the reference's CLI order.
MEASURE_NAMES = [
    "norm", "cosine", "dot", "rmse", "geman", "attention", "emd",
    "canberra", "hellinger", "chisquared1", "chisquared2", "gfc",
    "pearson", "jeffrey", "squaredchord", "smith", "sharpened_cosine", "scs",
]


# --------------------------------------------------------------------------
# Separable (channel-accumulator) forms.
#
# Almost every measure is Σ_c f(center_c, neighbor_c) over channels followed
# by a scalar tail. ``map_terms`` returns the per-channel addends and
# ``finalize_sums`` turns the accumulated sums into the measure value
# (the same math as ``pairwise``, reassociated only). This table is what the
# JAX dispatch reads to send a large map to its channels-first kernel, and
# it is the written source of the large-map CUDA kernel's per-channel terms
# and tails (``csrc/nfp_measures.cuh``).
#
# Not separable: ``pearson`` (centred two-pass form), ``mahalanobis``
# (per-sample statistics). ``attention`` = separable ``dot`` + a softmax
# over the neighbours that runs outside the kernel.
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SeparableMeasure:
    """Channel-accumulated form: value = finalize_sums(Σ_c map_terms(c, n))."""

    n_acc: int
    map_terms: Callable  # (c, n, cfg) -> tuple of n_acc per-channel terms
    finalize_sums: Callable  # (sums tuple, num_channels, cfg) -> value


def _sep_norm_terms(c, n, cfg):
    d = _abs(c - n)
    if cfg.p == 1:
        return (d,)
    return (d * d,) if cfg.p == 2 else (d ** cfg.p,)


def _sep_norm_fin(s, nc, cfg):
    if cfg.p == 1:
        return s[0]
    return safe_sqrt(s[0]) if cfg.p == 2 else s[0] ** (1.0 / cfg.p)


def _sep_dot_terms(c, n, cfg):
    return (c * n,)


def _sep_moments(c, n, cfg):
    return (c * n, c * c, n * n)


def _sep_identity(s, nc, cfg):
    return s[0]


def _sep_sqrt_abs(c, n, cfg):
    return (torch.sqrt(_abs(c) + cfg.eps) - torch.sqrt(_abs(n) + cfg.eps)) ** 2


def _sep_jeffrey_terms(c, n, cfg):
    a = _abs(c) + cfg.eps
    b = _abs(n) + cfg.eps
    return ((a - b) * torch.log(a / b),)


SEPARABLE: Dict[str, SeparableMeasure] = {
    "norm": SeparableMeasure(1, _sep_norm_terms, _sep_norm_fin),
    "cosine": SeparableMeasure(
        3, _sep_moments,
        lambda s, nc, cfg: s[0] / (torch.clamp(safe_sqrt(s[1]), min=cfg.eps)
                                   * torch.clamp(safe_sqrt(s[2]), min=cfg.eps))),
    "dot": SeparableMeasure(1, _sep_dot_terms, _sep_identity),
    "attention": SeparableMeasure(1, _sep_dot_terms, _sep_identity),
    "rmse": SeparableMeasure(1, lambda c, n, cfg: ((c - n) ** 2,),
                             lambda s, nc, cfg: safe_sqrt(s[0] / nc)),
    "geman": SeparableMeasure(
        1, lambda c, n, cfg: (((c - n) ** 2) / ((c - n) ** 2 + cfg.eps),),
        lambda s, nc, cfg: s[0] / nc),
    "emd": SeparableMeasure(1, lambda c, n, cfg: (_abs(c - n),), _sep_identity),
    "canberra": SeparableMeasure(
        1, lambda c, n, cfg: (_abs(c - n)
                              / (_abs(c) + _abs(n) + cfg.eps),),
        _sep_identity),
    "hellinger": SeparableMeasure(
        1, lambda c, n, cfg: (_sep_sqrt_abs(c, n, cfg),),
        lambda s, nc, cfg: safe_sqrt(0.5 * s[0])),
    "chisquared1": SeparableMeasure(
        1, lambda c, n, cfg: ((c - n) ** 2
                              / (_abs(c) + _abs(n) + cfg.eps),),
        _sep_identity),
    "chisquared2": SeparableMeasure(
        1, lambda c, n, cfg: ((c - n) ** 2 / (_abs(c) + cfg.eps),),
        _sep_identity),
    "gfc": SeparableMeasure(
        3, _sep_moments,
        lambda s, nc, cfg: s[0] / (safe_sqrt(s[1]) * safe_sqrt(s[2]) + cfg.eps)),
    "jeffrey": SeparableMeasure(1, _sep_jeffrey_terms, _sep_identity),
    "squaredchord": SeparableMeasure(
        1, lambda c, n, cfg: (_sep_sqrt_abs(c, n, cfg),), _sep_identity),
    "smith": SeparableMeasure(
        3, lambda c, n, cfg: (torch.minimum(_abs(c), _abs(n)),
                              _abs(c), _abs(n)),
        lambda s, nc, cfg: 1.0 - s[0] / (torch.minimum(s[1], s[2]) + cfg.eps)),
    "scs": SeparableMeasure(
        3, _sep_moments,
        lambda s, nc, cfg: _scs_from_cos(
            s[0] / ((safe_sqrt(s[1]) + cfg.q_scs)
                    * (safe_sqrt(s[2]) + cfg.q_scs)), cfg.p)),
}


def get_separable(name: str) -> Optional[SeparableMeasure]:
    return SEPARABLE.get(canonical_measure_name(name))


def canonical_measure_name(name: str) -> str:
    name = name.lower()
    return _ALIASES.get(name, name)


def get_measure(name: str) -> Measure:
    key = canonical_measure_name(name)
    if key not in MEASURES:
        raise ValueError(
            f"Similarity measure {name!r} not implemented; "
            f"available: {sorted(MEASURES)}"
        )
    return MEASURES[key]
