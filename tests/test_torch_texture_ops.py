"""The port's other texture ops (fractal, lacunarity, DeepTEN, RADAM)
against the JAX package's, on the CPU.

Both sides get the same seeded numpy inputs. Each op is held to its JAX
function forward and in its gradient: the vector-Jacobian product of a
fixed random cotangent, ``jax.vjp`` against ``torch.autograd.grad``.
RADAM's frozen constants are numpy on both sides and must be the same bits.

Tolerance: the repo's fp32 bar, 1e-4 (gradients relative to each tensor's
largest magnitude).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neighbour_feature_pooling_tpu.ops import deepten as jdeepten
from neighbour_feature_pooling_tpu.ops import fractal as jfractal
from neighbour_feature_pooling_tpu.ops import lacunarity as jlacunarity
from neighbour_feature_pooling_tpu.ops import radam as jradam
from neighbour_feature_pooling_tpu_torch.ops import deepten, fractal, lacunarity, radam
from test_torch_model import jit_reference, one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-4)


def _x(shape, seed=0, scale=1.0, offset=0.0):
    rng = np.random.default_rng(seed)
    return (offset + scale * rng.standard_normal(shape)).astype(np.float32)


def _check_vjp(jax_fn, torch_fn, inputs, seed=99):
    """``jax_fn`` and ``torch_fn`` of the same numpy ``inputs``: outputs
    within 1e-4, and the gradients of ``<out, g>`` for one seeded cotangent
    g within 1e-4 of each input's largest gradient. Returns the output."""
    def out_and_grads(args, cot):  # one jit: one XLA compile, not one per op
        out, vjp = jax.vjp(jax_fn, *args)
        return out, vjp(cot)

    g = _x(jax.eval_shape(jax_fn, *inputs).shape, seed)
    want, want_grads = jit_reference(out_and_grads)(inputs, g)
    want = np.asarray(want)
    ts = [torch.from_numpy(a.copy()).requires_grad_(True) for a in inputs]
    got = torch_fn(*ts)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    got_grads = torch.autograd.grad(got, ts, torch.from_numpy(g))
    for i, (w, t) in enumerate(zip(want_grads, got_grads)):
        w = np.asarray(w)
        assert np.isfinite(t.numpy()).all(), f"input {i}: non-finite gradient"
        err = float(np.abs(t.numpy() - w).max()) / max(float(np.abs(w).max()), 1e-30)
        assert err <= 1e-4, f"input {i}: gradient off by {err:.2e} of its max"
    return got.detach().numpy()


# --------------------------------------------------------------------- fractal


@pytest.mark.parametrize("shape", [(2, 7, 9, 5), (1, 6, 6, 3)])
def test_gdcb_fractal_dim_matches_jax(shape):
    """Five VALID max-pools (the smallest legal map, 6x6, among them), the
    log2 transform and the least-squares slope, forward and gradient."""
    _check_vjp(jfractal.gdcb_fractal_dim, fractal.gdcb_fractal_dim, [_x(shape)])


def test_gdcb_fractal_dim_raises_on_a_small_map_as_jax():
    x = _x((1, 5, 8, 2))
    with pytest.raises(ValueError) as want:
        jfractal.gdcb_fractal_dim(jnp.asarray(x))
    with pytest.raises(ValueError) as got:
        fractal.gdcb_fractal_dim(torch.from_numpy(x))
    assert str(got.value) == str(want.value)


# ------------------------------------------------------------------ lacunarity


# rank 4 global and windowed (the map kept and averaged), rank 3 (whose n
# counts the channels too) and rank 5 (whose n drops the depth); a
# saturated input where sigmoid(2x) and tanh differ
@pytest.mark.parametrize("shape,kw,scale", [
    ((2, 6, 5, 4), {}, 1.0),
    ((2, 6, 5, 4), dict(kernel=(3, 2), stride=(1, 2)), 1.0),
    ((2, 6, 5, 4), dict(kernel=(2, 2), keep_spatial=True), 1.0),
    ((2, 9, 4), {}, 1.0),
    ((2, 9, 4), dict(kernel=(3,), stride=(2,)), 1.0),
    ((1, 3, 4, 5, 2), {}, 1.0),
    ((1, 3, 4, 5, 2), dict(kernel=(2, 2, 3), stride=(1, 2, 1)), 1.0),
    ((2, 4, 4, 3), {}, 6.0),
])
def test_base_lacunarity_matches_jax(shape, kw, scale):
    _check_vjp(lambda x: jlacunarity.base_lacunarity(x, **kw),
               lambda x: lacunarity.base_lacunarity(x, **kw), [_x(shape, scale=scale)])


# --------------------------------------------------------------------- DeepTEN


def _expanded_distances(x, c):
    """The ‖x‖² − 2x·c + ‖c‖² form the port must not use."""
    return ((x * x).sum(-1, keepdim=True) - 2 * x @ c.T + (c * c).sum(-1)).clamp_min(0)


@pytest.mark.parametrize("chunk_elements", [1 << 25, 64])
def test_deepten_encode_matches_jax_at_a_large_offset(chunk_elements, monkeypatch):
    """Features with a common offset of 30 (codewords near it): the exact
    residuals agree with JAX within 1e-4, forward and in the gradients of
    the features, codewords and scales, where the expanded distances are
    off by more than that. With a tiny chunk budget the distance pass and
    its backward run one codeword at a time."""
    monkeypatch.setattr(deepten, "_CHUNK_ELEMENTS", chunk_elements)
    b, n, d, k = 2, 12, 16, 5
    x = _x((b, n, d), 1, offset=30.0)
    c = _x((k, d), 2, scale=0.2, offset=30.0)
    s = -np.random.default_rng(3).uniform(0.05, 0.2, k).astype(np.float32)
    _check_vjp(jdeepten.deepten_encode, deepten.deepten_encode, [x, c, s])
    exact = deepten._SquaredDistances.apply(torch.from_numpy(x), torch.from_numpy(c))
    want = ((x[:, :, None, :].astype(np.float64) - c.astype(np.float64)) ** 2).sum(-1)
    np.testing.assert_allclose(exact.numpy(), want, rtol=1e-5)
    expanded = _expanded_distances(torch.from_numpy(x), torch.from_numpy(c)).numpy()
    assert np.abs(expanded - want).max() > 1e-4 * np.abs(want).max()


def test_deepten_init_draws_in_the_jax_ranges():
    cw, s = deepten.deepten_init(32, 512, torch.Generator().manual_seed(0))
    std = 1 / np.sqrt(32 * 512)
    assert cw.shape == (32, 512) and s.shape == (32,)
    assert -std <= float(cw.min()) < -0.9 * std and 0.9 * std < float(cw.max()) <= std
    assert -1.0 <= float(s.min()) and float(s.max()) <= 0.0


# ----------------------------------------------------------------------- RADAM


def test_radam_constants_equal_jax_bit_for_bit():
    np.testing.assert_array_equal(radam.lcg_sequence(), jradam.lcg_sequence())
    for m, c in ((4, 512), (4, 960), (4, 192), (2, 7)):
        np.testing.assert_array_equal(radam.radam_alphas(m, c), jradam.radam_alphas(m, c))
    for d, h, w in ((512, 7, 7), (192, 14, 14), (6, 3, 5), (2048, 7, 7)):
        np.testing.assert_array_equal(radam.positional_encoding_2d(d, h, w),
                                      jradam.positional_encoding_2d(d, h, w))
    np.testing.assert_array_equal(radam.lcg_weights(3, 5, 11), jradam.lcg_weights(3, 5, 11))


# the identity (7 → 7), shrink (9x11 → 7) and grow (3 → 7) resize paths,
# with and without the positional encoding; a dead (all-zero) channel
@pytest.mark.parametrize("hw,pe,dead", [((7, 7), True, False), ((9, 11), True, False),
                                        ((3, 3), True, False), ((7, 7), False, True)])
def test_radam_pool_matches_jax(hw, pe, dead):
    c, ss = 6, 7
    x = _x((2,) + hw + (c,), 4)
    if dead:
        x[:, :, :, 2] = 0.0
    alphas = radam.radam_alphas(4, c)
    enc = radam.positional_encoding_2d(c, ss, ss).reshape(c, ss * ss) if pe else None
    jpe = None if enc is None else jnp.asarray(enc)
    tpe = None if enc is None else torch.from_numpy(enc)
    _check_vjp(lambda v: jradam.radam_pool(v, jnp.asarray(alphas), jpe, spatial_size=ss),
               lambda v: radam.radam_pool(v, torch.from_numpy(alphas), tpe, spatial_size=ss),
               [x])


def test_radam_pool_scrubs_a_saturated_rae_as_jax():
    """An RAE whose hidden units all underflow (h2 == 0) adds 0, with a
    finite gradient: huge alphas push every sigmoid to exactly 0."""
    c = 3
    x = np.abs(_x((1, 7, 7, c), 5)) + 0.5
    alphas = -1e4 * np.ones((2, 1, c), np.float32)
    alphas[1] = radam.radam_alphas(1, c)[0]
    out = _check_vjp(lambda v: jradam.radam_pool(v, jnp.asarray(alphas), None, spatial_size=7),
                     lambda v: radam.radam_pool(v, torch.from_numpy(alphas), None,
                                                spatial_size=7), [x])
    assert np.isfinite(out).all()
