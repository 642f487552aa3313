"""The PyTorch port's training engine against the JAX package's, on the CPU.

Both sides get the same numpy inputs and the same weights: the JAX
variables are initialised from ``PRNGKey(0)`` and carried into the port by
``state_dict_from_flax``. The JAX ``nfp`` runs its Pallas kernel in
interpret mode forward and ``jax.vjp`` of its XLA oracle backward; the
port's ``nfp`` is an ``autograd.Function`` on the card whose backward
differentiates the plain version, run here with the plain version in the
kernel's place (``_differentiable``), and the plain version itself on a CPU
tensor.

Tolerances: the repo's fp32 bar, 1e-4 (values relative to each tensor's
largest magnitude for gradients); BatchNorm running statistics 1e-5 (flax
takes the batch variance as E[x²] − E[x]², torch in two passes). New
parameters after Adam's first step are compared only where |g| > 1e-3 ·
max|g| of the tensor: there the update is lr · sign(g) to rounding, while
where |g| is near Adam's eps the sign of a rounding-level gradient decides
it.
"""

import copy
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from neighbour_feature_pooling_tpu import ops as jops
from neighbour_feature_pooling_tpu.models import get_model as jax_get_model
from neighbour_feature_pooling_tpu.ops.common import safe_sqrt as jax_safe_sqrt
from neighbour_feature_pooling_tpu.train import engine as jengine
from neighbour_feature_pooling_tpu.train import metrics as jmetrics
from neighbour_feature_pooling_tpu_torch.models import get_model, state_dict_from_flax
from neighbour_feature_pooling_tpu_torch.models.batchnorm import BatchNorm2d
from neighbour_feature_pooling_tpu_torch.models.from_jax import _param, torch_module_name
from neighbour_feature_pooling_tpu_torch.ops import MEASURE_NAMES, nfp, nfp_reference
from neighbour_feature_pooling_tpu_torch.ops.common import safe_sqrt
from neighbour_feature_pooling_tpu_torch.ops.nfp_cuda import _differentiable
from neighbour_feature_pooling_tpu_torch.train import engine, metrics

TOL = dict(rtol=1e-4, atol=1e-4)
ALL_MEASURES = MEASURE_NAMES + ["mahalanobis"]
NUM_CLASSES = 3
LR = 1e-3


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# ------------------------------------------------------------------ safe_sqrt


def test_safe_sqrt_grad_matches_jax():
    """0.5/sqrt(s) where s > 0 and exactly 0 at s == 0 (torch.sqrt's is inf)."""
    s = np.array([0.0, 1e-30, 0.25, 4.0, 0.0, 9.0], np.float32)
    want = np.asarray(jax.grad(lambda v: jnp.sum(jax_safe_sqrt(v)))(jnp.asarray(s)))
    t = torch.from_numpy(s).requires_grad_(True)
    y = safe_sqrt(t)
    y.sum().backward()
    assert torch.equal(y.detach(), torch.sqrt(torch.from_numpy(s)))
    assert t.grad[0] == 0 and t.grad[4] == 0
    np.testing.assert_allclose(t.grad.numpy(), want, rtol=1e-6)


# ---------------------------------------------------------- nfp input grads


_JAX_VJPS = {}


def _grad_case(measure, fuse_gap):
    """(x, cotangent) of one gradient case."""
    g = _x((2, 8) if fuse_gap else (2, 5, 5, 8), seed=100)
    return _x((2, 5, 5, 8), seed=ALL_MEASURES.index(measure)), g


def _jax_nfp_vjp(measure, fuse_gap):
    """(output, input gradient) of the JAX ``nfp``; both forms of a measure
    come from one jitted function (one compile)."""
    if measure not in _JAX_VJPS:
        def both(cases):
            out = {}
            for fuse, (x, g) in cases.items():
                y, vjp = jax.vjp(lambda v: jops.nfp(v, 1, measure, padding=1, fuse_gap=fuse), x)
                out[fuse] = (y, vjp(g)[0])
            return out

        cases = {fuse: tuple(map(jnp.asarray, _grad_case(measure, fuse))) for fuse in (False, True)}
        _JAX_VJPS[measure] = jax.tree_util.tree_map(np.asarray, jax.jit(both)(cases))
    return _JAX_VJPS[measure][fuse_gap]


@pytest.mark.parametrize("fuse_gap", [False, True])
@pytest.mark.parametrize("measure", ALL_MEASURES)
def test_nfp_input_grads_match_jax_vjp(measure, fuse_gap, monkeypatch):
    """The Function's backward (plain version as the kernel) and the CPU
    route's autograd against ``jax.vjp`` of the JAX ``nfp``: 5×5 map, R=1,
    reflect padding 1. The JAX ``nfp`` computes its forward through its XLA
    oracle here, not its Pallas kernel in interpret mode (a quarter of the
    time; the kernel's forward is held in ``test_torch_nfp.py``): its
    backward differentiates the oracle either way (nfp_pallas.py:647-661)."""
    monkeypatch.setattr(importlib.import_module("neighbour_feature_pooling_tpu.ops.nfp_pallas"),
                        "pallas_supported", lambda measure, stride: False)
    x, g = _grad_case(measure, fuse_gap)
    want_out, want_dx = _jax_nfp_vjp(measure, fuse_gap)
    ref_kw = dict(radius=1, measure=measure, padding=1, fuse_gap=fuse_gap)

    def plain_kernel(xx):
        return nfp_reference(xx, **ref_kw)

    for route in ("function", "cpu"):
        xt = torch.from_numpy(x).requires_grad_(True)
        out = (_differentiable(xt, plain_kernel, ref_kw) if route == "function"
               else nfp(xt, 1, measure, padding=1, fuse_gap=fuse_gap))
        (dx,) = torch.autograd.grad(out, xt, torch.from_numpy(g))
        np.testing.assert_allclose(out.detach().numpy(), want_out, **TOL, err_msg=route)
        np.testing.assert_allclose(dx.numpy(), want_dx, **TOL, err_msg=route)


def test_function_backward_recomputes_the_plain_version():
    """The kernel runs forward only: its output is what the Function
    returns, and the backward never calls it."""
    calls = []
    ref_kw = dict(radius=1, measure="cosine", padding=1, fuse_gap=True)

    def kernel(xx):
        calls.append(torch.is_grad_enabled())
        return nfp_reference(xx, **ref_kw) + 1.0  # marks the kernel's output

    xt = torch.from_numpy(_x((2, 7, 7, 16))).requires_grad_(True)
    out = _differentiable(xt, kernel, ref_kw)
    np.testing.assert_array_equal(out.detach().numpy(),
                                  nfp_reference(xt.detach(), **ref_kw).numpy() + 1.0)
    out.sum().backward()
    assert calls == [False]
    with torch.no_grad():
        _differentiable(xt, kernel, ref_kw)
    assert len(calls) == 2


DEGENERATE = ("constant", "dead_channels", "zeros")
_DEGENERATE_JAX = {}


def _degenerate_input(case):
    if case == "constant":
        return np.ones((1, 5, 5, 8), np.float32) * 0.37
    if case == "zeros":
        return np.zeros((1, 5, 5, 8), np.float32)
    x = np.random.default_rng(3).standard_normal((1, 5, 5, 8)).astype(np.float32)
    x[..., :4] = 0.0
    return x


def _jax_degenerate(measure, case):
    """JAX's loss and gradient of one case: the three cases of a measure as
    one batch of three maps through one jitted vjp (each map's loss is its
    own sum: the NFP of one image never reads another's)."""
    if measure not in _DEGENERATE_JAX:
        def losses_and_grads(xs):
            vals, vjp = jax.vjp(lambda v: jnp.sum(jops.nfp_reference(v, 1, measure, padding=1),
                                                  axis=(1, 2, 3)), xs)
            return vals, vjp(jnp.ones(len(DEGENERATE)))[0]

        vals, grads = map(np.asarray, jax.jit(losses_and_grads)(
            jnp.asarray(np.concatenate([_degenerate_input(c) for c in DEGENERATE]))))
        _DEGENERATE_JAX[measure] = {c: (float(vals[i]), grads[i:i + 1])
                                    for i, c in enumerate(DEGENERATE)}
    return _DEGENERATE_JAX[measure][case]


@pytest.mark.parametrize("case", DEGENERATE)
@pytest.mark.parametrize("measure", MEASURE_NAMES)
def test_nfp_grads_finite_at_degenerate_inputs(measure, case):
    """Every measure's backward is finite where centre == neighbour, where
    channels are dead and on the all-zero map (tests/test_grad_robustness.py
    on the JAX side); the loss and the gradient equal JAX's, including the
    subgradient of |x| at 0."""
    x = _degenerate_input(case)
    val, want = _jax_degenerate(measure, case)
    xt = torch.from_numpy(x).requires_grad_(True)
    loss = torch.sum(nfp(xt, 1, measure, padding=1))
    loss.backward()
    assert torch.isfinite(loss), f"{measure}/{case}: forward not finite"
    assert torch.isfinite(xt.grad).all(), f"{measure}/{case}: NaN/Inf grad"
    np.testing.assert_allclose(float(loss.detach()), float(val), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), **TOL)


# ------------------------------------------------------- loss and metrics


def test_cross_entropy_loss_with_padding_weights():
    logits = _x((6, 5), seed=1) * 3
    labels = np.array([0, 4, 2, 2, 1, 3], np.int32)
    for weights in (np.ones(6, np.float32), np.array([1, 1, 1, 1, 0, 0], np.float32),
                    np.zeros(6, np.float32)):
        want = float(jengine.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels),
                                                jnp.asarray(weights)))
        got = float(engine.cross_entropy_loss(torch.from_numpy(logits),
                                              torch.from_numpy(labels),
                                              torch.from_numpy(weights)))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_confusion_and_metrics_match_jax():
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((40, 4)).astype(np.float32)
    logits[3] = 0.0  # a tie: argmax takes the first class on both sides
    labels = rng.integers(0, 4, 40).astype(np.int32)
    labels[labels == 3] = 2  # class 3 has no true samples
    weights = (rng.random(40) > 0.2).astype(np.float32)
    want_cm = jmetrics.confusion_matrix_update(jmetrics.init_confusion(4), jnp.asarray(logits),
                                               jnp.asarray(labels), jnp.asarray(weights))
    got_cm = metrics.confusion_matrix_update(metrics.init_confusion(4), torch.from_numpy(logits),
                                             torch.from_numpy(labels), torch.from_numpy(weights))
    np.testing.assert_array_equal(got_cm.numpy(), np.asarray(want_cm))
    want = {k: float(v) for k, v in jmetrics.metrics_from_confusion(want_cm).items()}
    got = metrics.metrics_from_confusion(got_cm)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
    assert metrics.metrics_from_confusion_np(np.asarray(want_cm)) == got


# --------------------------------------------------------------- the step


class _Step:
    """A JAX ResNet18 + texture_nfp train state at 64 px (2×2 head map),
    its batch, and the port's model with the same weights."""

    def __init__(self, grad_accum=1, scheduler="none", total_steps=0):
        self.jmodel = jax_get_model("resnet18", "texture_nfp", NUM_CLASSES)
        rng = np.random.default_rng(0)
        self.images = rng.standard_normal((3, 4, 64, 64, 3)).astype(np.float32)
        self.labels = np.array([[0, 1, 2, 1], [2, 2, 0, 1], [1, 0, 0, 2]], np.int32)
        self.weights = np.array([[1, 1, 1, 0], [1, 1, 1, 1], [0, 1, 1, 1]], np.float32)
        self.jstate = jengine.create_train_state(
            self.jmodel, jax.random.PRNGKey(0), self.jbatch(0), LR, scheduler=scheduler,
            total_steps=total_steps, grad_accum=grad_accum)
        variables = {"params": self.jstate.params, "batch_stats": self.jstate.batch_stats}
        sd = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, variables))
        self.model = get_model("resnet18", "texture_nfp", NUM_CLASSES)
        self.state = engine.create_train_state(self.model, 0, LR, scheduler=scheduler,
                                               total_steps=total_steps,
                                               grad_accum=grad_accum, init_variables=sd)
        self._jstep = jax.jit(lambda s, b: jengine.train_step_body(
            s, b, jax.random.PRNGKey(1), False, NUM_CLASSES))

    def jbatch(self, i):
        return {"image": jnp.asarray(self.images[i]), "label": jnp.asarray(self.labels[i]),
                "weight": jnp.asarray(self.weights[i])}

    def batch(self, i):
        return {"image": torch.from_numpy(self.images[i]),
                "label": torch.from_numpy(self.labels[i]),
                "weight": torch.from_numpy(self.weights[i])}

    def step(self, i):
        self.jstate, jloss, jcm = self._jstep(self.jstate, self.jbatch(i))
        loss, cm = engine.train_step(self.state, self.batch(i), NUM_CLASSES)
        np.testing.assert_allclose(float(loss), float(jloss), **TOL)
        np.testing.assert_array_equal(cm.numpy(), np.asarray(jcm))


def _by_port_name(tree, stats=False):
    """{port name: numpy array in the port's layout} of a flax tree."""
    out = {}
    for path, v in jax.tree_util.tree_leaves_with_path(tree):
        names = [p.key for p in path]
        if stats:
            leaf, arr = {"mean": "running_mean", "var": "running_var"}[names[-1]], np.asarray(v)
        else:
            leaf, arr = _param(names[-1], np.asarray(v))
        out[f"{torch_module_name(tuple(names[:-1]))}.{leaf}"] = arr
    return out


def _check_grads(model, want):
    got = dict(model.named_parameters())
    assert set(got) == set(want)
    for name, g in want.items():
        scale = max(float(np.abs(g).max()), 1e-30)
        err = float(np.abs(got[name].grad.numpy() - g).max()) / scale
        assert err <= 1e-4, f"{name}: grad off by {err:.2e} of its max"


def _check_params(model, want, grads):
    got = dict(model.named_parameters())
    for name, p in want.items():
        g = np.abs(grads[name])
        sel = g > 1e-3 * g.max()
        np.testing.assert_allclose(got[name].detach().numpy()[sel], p[sel], **TOL,
                                   err_msg=name)


def _check_stats(model, jstate):
    sd = model.state_dict()
    for name, v in _by_port_name(jstate.batch_stats, stats=True).items():
        np.testing.assert_allclose(sd[name].numpy(), v, rtol=1e-5, atol=1e-5, err_msg=name)


@pytest.fixture(scope="module")
def one_step():
    s = _Step()
    s.step(0)
    return s


def test_train_step_loss_and_grads_match_jax(one_step):
    """Loss within 1e-4; every parameter's gradient within 1e-4 of its
    largest magnitude. The JAX gradients are read from Adam's first
    moment after one step (mu = (1 − b1)·g)."""
    mu = _by_port_name(one_step.jstate.opt_state[0].mu)
    _check_grads(one_step.model, {k: v / 0.1 for k, v in mu.items()})


def test_train_step_params_and_batch_stats_match_jax(one_step):
    mu = _by_port_name(one_step.jstate.opt_state[0].mu)
    _check_params(one_step.model, _by_port_name(one_step.jstate.params), mu)
    _check_stats(one_step.model, one_step.jstate)
    assert one_step.state.step == int(one_step.jstate.step) == 1


def test_grad_accum_three_steps_match_multisteps():
    """grad_accum=2 against optax MultiSteps: one update after two steps
    with the mean gradient, BatchNorm statistics moving on every step, and
    the third step's loss and its gradient, held for the next window.

    After the update the two models differ by up to lr where |g| is near
    Adam's eps (the module docstring), so the third step's gradient is held
    against the port's own gradient at its parameters (and JAX's against
    JAX's), its loss against JAX's."""
    s = _Step(grad_accum=2)
    before = {n: p.detach().clone() for n, p in s.model.named_parameters()}
    s.step(0)
    for n, p in s.model.named_parameters():
        assert torch.equal(p.detach(), before[n]), f"{n} moved before the window closed"
    _check_stats(s.model, s.jstate)
    s.step(1)
    inner = s.jstate.opt_state.inner_opt_state[0]
    mean_g = {k: v / 0.1 for k, v in _by_port_name(inner.mu).items()}
    _check_grads(s.model, mean_g)
    _check_params(s.model, _by_port_name(s.jstate.params), mean_g)
    _check_stats(s.model, s.jstate)
    twin = copy.deepcopy(s.model).train()
    names, params = zip(*twin.named_parameters())
    loss = engine.cross_entropy_loss(twin(s.batch(2)["image"]), s.batch(2)["label"],
                                     s.batch(2)["weight"])
    own_g3 = dict(zip(names, torch.autograd.grad(loss, params)))
    s.step(2)
    for name, p in s.model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), own_g3[name].numpy(), rtol=1e-6, atol=1e-9,
                                   err_msg=name)
    assert int(s.jstate.opt_state.mini_step) == 1
    assert s.state.step == int(s.jstate.step) == 3 and s.state.updates == 1


def test_freeze_mask_selects_the_jax_tensors():
    """The port's mask over its parameter names selects, through
    ``from_jax``'s name map, the tensors the JAX mask selects."""
    jmodel = jax_get_model("resnet18", "texture_nfp", NUM_CLASSES)
    params = jmodel.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 32, 32, 3)),
                         train=False)["params"]
    model = get_model("resnet18", "texture_nfp", NUM_CLASSES)
    for subs in (engine.FREEZE_SUBSTRINGS, ("nfp_proj",), ("bn2", "fc"), ("layer4",),
                 ("conv",)):
        mask = jengine.freeze_mask(params, subs)
        want = {k for k, v in _by_port_name(jax.tree_util.tree_map(
            lambda m, p: np.full(p.shape, m, np.float32), mask, params)).items()
            if float(v.max()) == 0.0}
        got = {k for k, v in engine.freeze_mask(model, subs).items() if v == 0.0}
        assert got == want, subs
        assert (len(got) == 0) == (subs == engine.FREEZE_SUBSTRINGS)


def test_frozen_grads_are_zero_tensors_and_adam_still_counts():
    """While frozen, the masked parameters get zero gradients (not None),
    so torch's Adam counts their step as optax does."""
    model = get_model("resnet18", "texture_nfp", NUM_CLASSES)
    state = engine.create_train_state(model, 0, LR)
    rng = np.random.default_rng(5)
    batch = {"image": torch.from_numpy(rng.standard_normal((2, 32, 32, 3)).astype(np.float32)),
             "label": torch.tensor([0, 1]), "weight": torch.ones(2)}
    before = model.fc.weight.detach().clone()
    engine.train_step(state, batch, NUM_CLASSES, frozen=True, freeze_substrings=("fc",))
    assert torch.equal(model.fc.weight.grad, torch.zeros_like(before))
    assert torch.equal(model.fc.weight.detach(), before)
    assert int(state.optimizer.state[model.fc.weight]["step"]) == 1


def test_cosine_and_plateau_learning_rates_match_optax():
    """Cosine: the rate of update n is optax's ``cosine_decay_schedule`` at
    n (the count before the update), clipped after ``total_steps``. Plateau:
    the trainer sets the rate, which the next update uses."""
    sched = optax.cosine_decay_schedule(LR, 5)
    port = engine.cosine_decay_schedule(LR, 5)
    for n in range(8):
        np.testing.assert_allclose(port(n), float(sched(n)), rtol=1e-6, atol=1e-12)
    model = get_model("resnet18", "gap_only", NUM_CLASSES)
    state = engine.create_train_state(model, 0, LR, scheduler="cosine", total_steps=5)
    batch = {"image": torch.zeros((2, 32, 32, 3)), "label": torch.tensor([0, 1]),
             "weight": torch.ones(2)}
    for n in range(3):
        engine.train_step(state, batch, NUM_CLASSES)
        np.testing.assert_allclose(state.learning_rate, float(sched(n)), rtol=1e-6)
    plateau = engine.create_train_state(get_model("resnet18", "gap_only", NUM_CLASSES), 0, LR,
                                        scheduler="plateau")
    plateau.learning_rate = LR * 0.1
    assert all(g["lr"] == LR * 0.1 for g in plateau.optimizer.param_groups)


def test_batchnorm_running_stats_match_flax():
    """Train mode: normalised with the batch statistics; the running
    variance moves by the biased batch variance (momentum 0.9), as flax's
    ``nn.BatchNorm`` does. Eval mode is torch's, unchanged."""
    import flax.linen as fnn

    x = _x((4, 5, 5, 6), seed=7) * 2 + 1
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = bn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    y, upd = bn.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
    port = BatchNorm2d(6).train()
    got = port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(y), **TOL)
    np.testing.assert_allclose(port.running_mean.numpy(),
                               np.asarray(upd["batch_stats"]["mean"]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(port.running_var.numpy(),
                               np.asarray(upd["batch_stats"]["var"]), rtol=1e-5, atol=1e-5)
    port.eval()
    ref = torch.nn.BatchNorm2d(6).eval()
    ref.load_state_dict(port.state_dict())
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    assert torch.equal(port(xt), ref(xt))
