"""The PyTorch port's ViT-Tiny models against the JAX package's, on the CPU.

JAX trees are numpy draws on the tree traced from ``init``
(``test_torch_model.py::_draw_variables``); every LayerNorm scale and
shift, every bias, ``cls_token`` and ``pos_embed`` is then drawn away from
its identity value, so a swapped or transposed mapping (the fused qkv above all)
cannot hide behind an identity norm, a zero bias or a zero CLS token.
``state_dict_from_flax`` carries them into the port.

Tolerance: the repo's fp32 bar, 1e-4 on tokens and logits; one train step's
loss within 1e-4 and every gradient within 1e-4 of its tensor's largest
magnitude (the JAX gradient read from Adam's first moment).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from neighbour_feature_pooling_tpu.models import get_model as jax_get_model
from neighbour_feature_pooling_tpu.models.backbones.timm_port import port_vit
from neighbour_feature_pooling_tpu.models.backbones.vit import ViT as JaxViT
from neighbour_feature_pooling_tpu.train import engine as jengine
from neighbour_feature_pooling_tpu_torch.models import get_model, state_dict_from_flax
from neighbour_feature_pooling_tpu_torch.models.from_jax import flax_module_path, torch_module_name
from neighbour_feature_pooling_tpu_torch.models.backbones.vit import ViT, tokens_to_map
from neighbour_feature_pooling_tpu_torch.train import engine
from test_torch_model import _draw_variables, one_torch_thread  # noqa: F401

NUM_CLASSES = 3
TOL = dict(rtol=1e-4, atol=1e-4)
LR = 1e-3


def _randomise(variables, seed):
    """Numpy draws for every norm scale and shift, every bias and the CLS
    and position embeddings."""
    rng = np.random.default_rng(seed)
    draws = {"scale": lambda s: rng.uniform(0.5, 1.5, s),
             "bias": lambda s: 0.1 * rng.standard_normal(s),
             "cls_token": lambda s: rng.standard_normal(s),
             "pos_embed": lambda s: 0.5 * rng.standard_normal(s)}

    def leaf(path, v):
        name = getattr(path[-1], "key", str(path[-1]))
        v = np.asarray(v)
        return draws[name](v.shape).astype(np.float32) if name in draws else v

    return jax.tree_util.tree_map_with_path(leaf, variables)


def _images(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _init(model, size):
    return _draw_variables(model, np.zeros((1, size, size, 3), np.float32), train=False,
                           seed=size)


@pytest.fixture(scope="module")
def narrow():
    """A narrow JAX ViT (depth 2, dim 64, 2 heads, the 14×14 position grid)
    and the port's with the same weights."""
    jvit = JaxViT(embed_dim=64, depth=2, num_heads=2)
    variables = _randomise(jax.tree_util.tree_map(np.asarray, _init(jvit, 32)), seed=7)
    vit = ViT(embed_dim=64, depth=2, num_heads=2)
    vit.load_state_dict(state_dict_from_flax(variables), strict=True)
    return jvit, variables, vit.eval()


@pytest.mark.parametrize("size", [32, 48, 224, 256])
def test_narrow_tokens_match_jax(narrow, size):
    """32 and 48 px shrink the position grid (14 → 2, 3: antialiased),
    224 px keeps it, 256 px grows it (14 → 16)."""
    jvit, variables, vit = narrow
    x = _images((2, size, size, 3), seed=size)
    want = np.asarray(jax.jit(lambda v, xx: jvit.apply(v, xx))(variables, x))
    with torch.no_grad():
        got = vit(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 1 + (size // 16) ** 2, 64)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.fixture(scope="module")
def full():
    """ViT-Tiny + texture_nfp at full width, its randomised variables."""
    model = jax_get_model("vittiny", "texture_nfp", NUM_CLASSES)
    return model, _randomise(jax.tree_util.tree_map(np.asarray, _init(model, 64)), seed=8)


def _port(variant, variables):
    model = get_model("vittiny", variant, NUM_CLASSES)
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    return model.eval()


@pytest.mark.parametrize("variant,size,batch", [("texture_nfp", 224, 1), ("texture_nfp", 64, 2),
                                                ("gap_only", 64, 2)])
def test_logits_match_jax(full, variant, size, batch):
    """224 px: the 14×14 map, no resample; 64 px: a 4×4 map and the
    antialiased resample of the position grid."""
    model, variables = full
    if variant == "gap_only":
        model = jax_get_model("vittiny", "gap_only", NUM_CLASSES)
        variables = {"params": {k: v for k, v in variables["params"].items() if k != "pool"}}
    x = _images((batch, size, size, 3), seed=size)
    want = np.asarray(jax.jit(lambda v, xx: model.apply(v, xx, train=False))(variables, x))
    with torch.no_grad():
        got = _port(variant, variables)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (batch, NUM_CLASSES)
    np.testing.assert_allclose(got, want, **TOL)


def test_state_dict_keys_are_the_timm_keys(full):
    _, variables = full
    keys = set(_port("texture_nfp", variables).state_dict())
    for k in ("backbone.patch_embed.proj.weight", "backbone.patch_embed.proj.bias",
              "backbone.cls_token", "backbone.pos_embed", "backbone.blocks.0.norm1.weight",
              "backbone.blocks.11.attn.qkv.weight", "backbone.blocks.11.attn.qkv.bias",
              "backbone.blocks.3.attn.proj.weight", "backbone.blocks.3.mlp.fc1.weight",
              "backbone.blocks.3.mlp.fc2.bias", "backbone.norm.bias", "pool.nfp_proj.weight",
              "fc.weight"):
        assert k in keys, k
    assert _port("texture_nfp", variables).backbone.blocks[0].attn.qkv.weight.shape == (576, 192)


def test_module_names_map_both_ways(full):
    """``flax_module_path`` inverts ``torch_module_name`` on every ViT
    module with parameters; the fused qkv maps to the JAX int8 key of its
    matmul, ``proj_qkv``, which maps back to it, as ``query`` does."""
    _, variables = full
    model = _port("texture_nfp", variables)
    modules = {name.rsplit(".", 1)[0] for name, _ in model.named_parameters() if "." in name}
    for name in modules:
        assert torch_module_name(flax_module_path(name)) == name, name
    assert flax_module_path("backbone.blocks.3.attn.qkv") == ("backbone", "block_3", "attn",
                                                              "proj_qkv")
    assert flax_module_path("backbone.patch_embed.proj") == ("backbone", "patch_embed")
    assert torch_module_name(("backbone", "block_3", "attn", "query")) == "backbone.blocks.3.attn.qkv"
    assert torch_module_name(("backbone", "block_3", "attn", "out")) == "backbone.blocks.3.attn.proj"
    assert set(engine.freeze_mask(model)) == {n for n, _ in model.named_parameters()}


def test_port_vit_gives_back_the_flax_tree(full):
    """The port's backbone state_dict, read by the JAX timm porter
    (``port_vit``), gives back the flax backbone tree bit for bit."""
    _, variables = full
    sd = {k[len("backbone."):]: v.numpy()
          for k, v in _port("texture_nfp", variables).state_dict().items()
          if k.startswith("backbone.")}
    back = port_vit(sd, depth=12, num_heads=3)
    want = jax.tree_util.tree_leaves_with_path(variables["params"]["backbone"])
    got = dict(jax.tree_util.tree_leaves_with_path(back["params"]))
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(np.asarray(got[path]), leaf,
                                      err_msg=jax.tree_util.keystr(path))


def test_tokens_to_map_raises_on_a_count_that_is_not_a_square():
    tokens = torch.zeros(2, 1 + 16, 8)
    assert tokens_to_map(tokens).shape == (2, 4, 4, 8)
    with pytest.raises(ValueError, match="not a perfect square"):
        tokens_to_map(torch.zeros(2, 1 + 15, 8))


def test_train_step_matches_jax(full):
    """One train step at 64 px, B=2: the loss and every gradient."""
    model, variables = full
    rng = np.random.default_rng(9)
    images = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    labels, weights = np.array([1, 2], np.int32), np.ones(2, np.float32)
    tx = optax.adam(LR, b1=0.9, b2=0.999, eps=1e-8)
    jstate = jengine.TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                                batch_stats={}, opt_state=tx.init(variables["params"]), tx=tx,
                                apply_fn=model.apply)
    jstate, jloss, _ = jax.jit(lambda s, b: jengine.train_step_body(
        s, b, jax.random.PRNGKey(1), False, NUM_CLASSES))(
        jstate, {"image": images, "label": labels, "weight": weights})

    port = get_model("vittiny", "texture_nfp", NUM_CLASSES)
    state = engine.create_train_state(port, 0, LR, init_variables=state_dict_from_flax(variables))
    loss, _ = engine.train_step(state, {"image": torch.from_numpy(images),
                                        "label": torch.from_numpy(labels),
                                        "weight": torch.from_numpy(weights)}, NUM_CLASSES)
    np.testing.assert_allclose(float(loss), float(jloss), **TOL)
    grads = state_dict_from_flax({"params": jax.tree_util.tree_map(np.asarray,
                                                                   jstate.opt_state[0].mu)})
    got = dict(port.named_parameters())
    assert set(got) == set(grads)
    for name, m in grads.items():
        want = m.numpy() / 0.1  # Adam's first moment: mu = (1 − b1)·g
        err = float(np.abs(got[name].grad.numpy() - want).max()) / max(float(np.abs(want).max()),
                                                                        1e-30)
        assert err <= 1e-4, f"{name}: grad off by {err:.2e} of its max"
