"""Neighborhood Feature Pooling on the GPU: the CUDA kernel and the public op.

Counterpart of ``neighbour_feature_pooling_tpu/ops/nfp_pallas.py``.

* ``nfp_small_cuda`` wraps ``csrc/nfp_small.cu``, the Hopper port of the
  small-map TPU kernel ``_nfp_kernel_unrolled`` (maps of at most 256 output
  positions, stride 1, every stat-free measure, optional fused GAP). On a
  CPU tensor it runs the plain version, ``neighborhood.nfp_reference``.
* ``nfp`` dispatches as the JAX ``nfp`` does (``_forward_value``): a
  kernel-eligible CUDA input goes to the kernel; a configuration the JAX
  package sends to its XLA oracle goes to ``nfp_reference`` on either
  device; a CUDA input the JAX package sends to its large-map kernel raises
  until that kernel is ported; a CPU input runs ``nfp_reference``.

There is no fallback: a CUDA input the kernel should take either launches
it or raises. Gradients through the kernel come with the training slice
(an ``autograd.Function`` whose backward differentiates the plain version),
so a CUDA input that requires grad raises for now.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .measures import MEASURES, canonical_measure_name, get_measure
from .neighborhood import PAD_MODES, nfp_output_size, nfp_reference, num_neighbors

__all__ = ["nfp", "nfp_small_cuda", "kernel_supported"]

#: dispatch thresholds of the JAX ``nfp`` (nfp_pallas.py:433-439), kept so
#: both packages route every configuration the same way; they were chosen
#: on a TPU and are still to be re-derived for this card
_MAX_POSITIONS = 256
_CHW_MAX_CHANNELS = 48
_CHW_GAP_MAX_CHANNELS = 64
#: measures with a channel-accumulable form (measures.py ``SEPARABLE``):
#: all stat-free measures but the centred two-pass ``pearson``
_SEPARABLE = frozenset(MEASURES) - {"pearson", "mahalanobis"}

# keep in sync with the enums in csrc/nfp_small.cu
_MEASURE_IDS = {name: i for i, name in enumerate((
    "norm", "cosine", "dot", "rmse", "geman", "emd", "canberra", "hellinger",
    "chisquared1", "chisquared2", "gfc", "pearson", "jeffrey", "squaredchord",
    "smith", "scs"))}
_FINALIZE_IDS = {"neg_if_sim": 0, "neg_if_dist": 1, "one_minus_if_dist": 2}


def kernel_supported(measure: str, stride: int) -> bool:
    """The kernels cover stride 1 and every stat-free measure."""
    return get_measure(measure).name != "mahalanobis" and stride == 1


@functools.lru_cache(maxsize=None)
def _nfp_small_forward():
    fn = _build.load_library("nfp_small").nfp_small_forward
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 16
                   + [ctypes.c_float] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def nfp_small_cuda(
    x: torch.Tensor,
    radius: int = 1,
    measure: str = "cosine",
    *,
    similarity: bool = True,
    p: float = 1.0,
    eps: float = 1e-6,
    q_scs: float = 1e-6,
    padding: int = 0,
    dilation: int = 1,
    padding_mode: str = "reflect",
    fuse_gap: bool = False,
) -> torch.Tensor:
    """Small-map NFP(+GAP) on an NHWC map, stride 1.

    Returns ``(B, N)`` with ``fuse_gap``, else ``(B, H', W', N)``, in the
    input dtype. A CUDA input must be a contiguous fp32/bf16 NHWC tensor
    whose output map has at most 256 positions; anything else raises.
    ``attention`` runs the ``dot`` kernel, then a softmax over the
    neighbours, then the pooling, as ``nfp_pallas`` does.
    ``nfp_small_cuda.launches`` counts kernel launches.
    """
    if x.device.type == "cpu":
        return nfp_reference(
            x, radius, measure, similarity=similarity, p=p, eps=eps,
            q_scs=q_scs, padding=padding, dilation=dilation,
            padding_mode=padding_mode, fuse_gap=fuse_gap)
    m = get_measure(measure)
    if m.needs_softmax_over_neighbors:
        raw = nfp_small_cuda(x, radius, "dot", similarity=True, p=p, eps=eps,
                             q_scs=q_scs, padding=padding, dilation=dilation,
                             padding_mode=padding_mode, fuse_gap=False)
        out = m.finalize(torch.softmax(raw, dim=-1), similarity)
        return torch.mean(out, dim=(1, 2)) if fuse_gap else out

    if x.device.type != "cuda":
        raise ValueError(f"nfp_small_cuda takes a CUDA or CPU tensor, got {x.device}")
    if x.ndim != 4:
        raise ValueError(f"nfp expects a 4-D NHWC map, got shape {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"nfp_small_cuda takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("nfp_small_cuda needs a contiguous NHWC tensor")
    if torch.is_grad_enabled() and x.requires_grad:
        raise NotImplementedError(
            "the NFP kernel has no backward yet (training slice, ROADMAP.md "
            "Queue 1 item 2); run under torch.no_grad()/inference_mode()")
    if m.name not in _MEASURE_IDS:
        raise ValueError(f"the NFP kernel does not take measure {m.name!r}")
    if padding_mode not in PAD_MODES:
        raise ValueError(f"Unsupported padding_mode {padding_mode!r}; "
                         f"one of {sorted(PAD_MODES)}")
    b, h, w, c = x.shape
    h_out = nfp_output_size(h, radius, 1, padding, dilation)
    w_out = nfp_output_size(w, radius, 1, padding, dilation)
    if h_out < 1 or w_out < 1:
        raise ValueError(
            f"NFP output size {h_out}x{w_out} invalid for input {h}x{w}, "
            f"R={radius}, padding={padding}, dilation={dilation}")
    if h_out * w_out > _MAX_POSITIONS:
        raise ValueError(f"nfp_small_cuda takes maps of at most {_MAX_POSITIONS} "
                         f"output positions, got {h_out}x{w_out}")
    n = num_neighbors(radius)
    out = torch.empty((b, n) if fuse_gap else (b, h_out, w_out, n),
                      dtype=torch.float32, device=x.device)
    if b == 0:  # an empty grid is not a valid launch
        return out.to(x.dtype)
    vec_width = 4 if x.dtype == torch.float32 else 8  # elements per 16 bytes
    vec = int(c % vec_width == 0 and x.data_ptr() % 16 == 0)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _nfp_small_forward()(
            x.data_ptr(), out.data_ptr(), int(x.dtype == torch.bfloat16),
            b, h, w, c, h_out, w_out, radius, dilation, padding,
            PAD_MODES.index(padding_mode), _MEASURE_IDS[m.name],
            _FINALIZE_IDS[m.finalize_kind], int(similarity), int(fuse_gap),
            vec, p, eps, q_scs, stream)
    if rc != 0:
        raise RuntimeError(f"nfp_small kernel launch failed: cudaError_t {rc}")
    nfp_small_cuda.launches += 1
    return out.to(x.dtype)


nfp_small_cuda.launches = 0


def _route(shape, radius, measure, stride, padding, dilation, data_format,
           fuse_gap) -> str:
    """Where the JAX ``nfp`` sends a configuration (``_forward_value``):
    ``"kernel"`` (the small-map kernel), ``"k2"`` (the large-map
    channels-first kernel) or ``"reference"`` (the plain version)."""
    h_axis, w_axis, c_axis = (2, 3, 1) if data_format == "NCHW" else (1, 2, 3)
    h_out = nfp_output_size(shape[h_axis], radius, stride, padding, dilation)
    w_out = nfp_output_size(shape[w_axis], radius, stride, padding, dilation)
    small_map = h_out * w_out <= _MAX_POSITIONS
    chw_cap = _CHW_GAP_MAX_CHANNELS if fuse_gap else _CHW_MAX_CHANNELS
    chw_eligible = (canonical_measure_name(measure) in _SEPARABLE
                    and shape[c_axis] <= chw_cap)
    if not (kernel_supported(measure, stride) and (small_map or chw_eligible)):
        return "reference"
    return "kernel" if small_map else "k2"


def nfp(
    x: torch.Tensor,
    radius: int = 1,
    measure: str = "cosine",
    similarity: bool = True,
    p: float = 1.0,
    eps: float = 1e-6,
    q_scs: float = 1e-6,
    stride: int = 1,
    padding: int = 0,
    dilation: int = 1,
    padding_mode: str = "reflect",
    data_format: str = "NHWC",
    fuse_gap: bool = False,
) -> torch.Tensor:
    """Neighborhood Feature Pooling (same signature as the JAX ``nfp``).

    See ``neighborhood.nfp_reference`` for the argument semantics and the
    module docstring for where each input runs.
    """
    ref_kw = dict(similarity=similarity, p=p, eps=eps, q_scs=q_scs,
                  stride=stride, padding=padding, dilation=dilation,
                  padding_mode=padding_mode, data_format=data_format,
                  fuse_gap=fuse_gap)
    route = _route(tuple(x.shape), radius, measure, stride, padding, dilation,
                   data_format, fuse_gap)
    if x.device.type != "cuda" or route == "reference":
        return nfp_reference(x, radius, measure, **ref_kw)
    if route == "k2":
        raise NotImplementedError(
            "K2 (nfp_pallas.py::_nfp_kernel_chw, the large-map NFP kernel) is "
            "not yet ported: ROADMAP.md Queue 2")
    xh = x.permute(0, 2, 3, 1) if data_format == "NCHW" else x
    out = nfp_small_cuda(
        xh.contiguous(), radius, measure, similarity=similarity, p=p, eps=eps,
        q_scs=q_scs, padding=padding, dilation=dilation,
        padding_mode=padding_mode, fuse_gap=fuse_gap)
    if not fuse_gap and data_format == "NCHW":
        out = out.permute(0, 3, 1, 2)
    return out
