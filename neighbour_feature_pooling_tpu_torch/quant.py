"""Post-training int8 quantization for serving (counterpart of
``neighbour_feature_pooling_tpu/quant.py``).

The JAX package's scheme, ported as it is: static per-output-channel
symmetric weight scales (``amax/127`` over the contraction axes), a
per-tensor activation scale (the batch's own ``amax/127``, or a calibrated
constant), exact ``s8 × s8 → s32`` accumulation, and a dequant epilogue
``acc·(x_scale·w_scale) + bias`` in fp32. BN folding, static calibration
and s8 chaining between convs work as there.

Where the JAX package intercepts flax calls at trace time, the port swaps
modules: ``quantize_model`` replaces every eligible ``nn.Conv2d`` by an
``Int8Conv2d`` and every eligible ``nn.Linear`` by an ``Int8Linear``, each
holding only its s8 weight, its per-output-channel scales and its folded
affine, and turns each folded ``nn.BatchNorm2d`` into ``nn.Identity``.
Layers are keyed by torch module name; ``models.from_jax.torch_module_name``
maps a JAX layer path to it.

On the card every int8 contraction runs through a hand-written kernel: a
1×1 conv with zero padding is subsampled and runs as a GEMM through K4
(``ops/int8_gemm.py``), as does ``Int8Linear``; every other eligible conv,
the thin-channel RGB stem included, runs through K5 (``ops/int8_conv.py``).
PyTorch has no int8 conv on CUDA, so there is no second route to choose,
and the JAX ``use_mxu_gemm`` switch, which picks between XLA's s8 ops and
the Pallas kernels on a TPU, has no counterpart. The JAX package's own
tests hold its two routes bit-identical, so the port matches both.
Ineligible layers stay fp32: grouped/depthwise or dilated convs, non-zero
padding modes, contractions below ``min_contraction``, the classifier
(``fc``), and the texture pooling ops. The int8 layers are the JAX
interceptor's, pair by pair, for every (backbone, variant) of the
registry: each eligible ``nn.Conv``, ``nn.Dense`` and ViT attention
projection there (``proj_qkv``, ``proj_out``) is an ``nn.Conv2d`` or
``nn.Linear`` here.

A ViT served int8 takes the JAX ViT's token layout, 197 tokens padded with
zero rows to 200 (``VIT_SEQ_ALIGN``, ``models/backbones/vit.py``): the pad
rows flow through every quantized projection, so they enter the per-tensor
amax, dynamic and calibrated, and on some weights they set it. Every
function here that runs or quantizes a model sets that layout on it first
(``_int8_layout``); the fp32 path keeps 197 tokens.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import warnings
from typing import Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from .models.backbones.vit import ViT
from .ops.int8_conv import int8_conv2d, pack_conv_weight
from .ops.int8_gemm import int8_gemm, pack_weight

__all__ = ["QuantConfig", "Int8Conv2d", "Int8Linear", "VIT_SEQ_ALIGN", "build_bn_folding",
           "build_int8_chains", "calibrate_act_scales", "prequantize_weights",
           "quantize_model"]

#: the JAX ViT's ``seq_align``, which its int8 tier runs with
VIT_SEQ_ALIGN = 8


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Eligibility policy and calibration state of the int8 tier.

    ``min_contraction``: smallest fan-in (``kh·kw·c_in`` for convs,
    ``in_features`` for linears) worth quantizing.
    ``skip_paths``: module-name components kept fp32 (the classifier).
    ``act_scales``: static activation scales from
    :func:`calibrate_act_scales` (``{module name: float}``); those layers
    skip the dynamic per-batch amax.
    ``bn_folding``: from :func:`build_bn_folding`; folded convs absorb the
    BN affine into their epilogue and the BN becomes identity.
    ``int8_chains``: from :func:`build_int8_chains` (needs ``act_scales``);
    producer convs requantize in their epilogue, ReLU fused, and emit s8.
    ``quantize_spatial=False`` is the mixed tier: only 1×1 convs and
    linears quantize.

    There is no ``use_mxu_gemm``: on the card K4 and K5 are the only int8
    route (module docstring).
    """

    min_contraction: int = 64
    skip_paths: Tuple[str, ...] = ("fc",)
    act_scales: Optional[dict] = None
    bn_folding: Optional[dict] = None
    int8_chains: Optional[dict] = None
    quantize_spatial: bool = True


@functools.lru_cache(maxsize=None)
def _const(value: float, device: torch.device) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.float32, device=device)


def _quantize(x: torch.Tensor, dims: Optional[Tuple[int, ...]] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization: one per-tensor scale, or with ``dims``
    one per slice, reduced over ``dims`` (keepdim). Returns
    ``(q_int8, scale_f32)`` with ``x ≈ q * scale``."""
    x = x.float()
    amax = (x.abs().amax() if dims is None
            else x.abs().amax(dim=dims, keepdim=True))
    # a tensor divisor: PyTorch's CUDA kernels divide by a Python scalar as
    # a multiply by its reciprocal, which can be an ulp off the quotient
    scale = torch.clamp_min(amax, 1e-12) / _const(127.0, amax.device)
    q = torch.clamp(torch.round(x / scale), -127.0, 127.0).to(torch.int8)
    return q, scale


def _quantize_act(x: torch.Tensor, act_scale: Optional[torch.Tensor]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Activation quantization: dynamic per-tensor amax, or a fixed
    calibrated scale (a 0-d fp32 tensor; values outside the calibration
    saturate). An int8 input comes from a chained producer, already
    quantized with this layer's calibrated scale."""
    if x.dtype == torch.int8:
        if act_scale is None:
            raise ValueError(
                "int8 activation input requires a calibrated act_scale "
                "(chained producers quantize with the consumer's scale)")
        return x, act_scale
    if act_scale is None:
        return _quantize(x)
    q = torch.clamp(torch.round(x.float() / act_scale), -127.0, 127.0).to(torch.int8)
    return q, act_scale


def _eligible(name: str, mod: nn.Module, cfg: QuantConfig) -> bool:
    """The JAX ``_conv_eligible`` and Dense rule, in torch terms."""
    if any(comp in cfg.skip_paths for comp in name.split(".")):
        return False
    if isinstance(mod, nn.Linear):
        return mod.in_features >= cfg.min_contraction
    if not isinstance(mod, nn.Conv2d):
        return False
    if (mod.groups != 1 or any(d != 1 for d in mod.dilation)
            or mod.padding_mode != "zeros"):
        return False
    ksize = tuple(mod.kernel_size)
    if not cfg.quantize_spatial and any(k != 1 for k in ksize):
        return False  # mixed tier: spatial convs stay float
    return mod.in_channels * ksize[0] * ksize[1] >= cfg.min_contraction


def _eligible_layers(model: nn.Module, cfg: QuantConfig) -> Iterator[Tuple[str, nn.Module]]:
    return ((n, m) for n, m in model.named_modules() if _eligible(n, m, cfg))


def _int8_layout(model: nn.Module) -> nn.Module:
    """Give every ViT in ``model``, in place, the JAX ViT's padded token
    layout (``seq_align = VIT_SEQ_ALIGN``; module docstring); returns
    ``model``."""
    for mod in model.modules():
        if isinstance(mod, ViT):
            mod.seq_align = VIT_SEQ_ALIGN
    return model


def prequantize_weights(model: nn.Module, config: Optional[QuantConfig] = None
                        ) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
    """Quantize every eligible layer's weight once, outside the serving
    loop: ``{module name: (wq, ws)}`` with ``wq`` the s8 weight in the
    module's own layout (OIHW, or ``(out, in)``) and ``ws`` its
    ``(out,)`` per-output-channel scales."""
    cfg = config or QuantConfig()
    out = {}
    with torch.no_grad():
        for name, mod in _eligible_layers(model, cfg):
            wq, ws = _quantize(mod.weight, dims=tuple(range(1, mod.weight.ndim)))
            out[name] = (wq, ws.reshape(-1))
    return out


def _buffer(value, device) -> Optional[torch.Tensor]:
    if value is None:
        return None
    return torch.as_tensor(value, dtype=torch.float32).to(device)


def _repack(module: nn.Module, incompatible_keys) -> None:
    """After ``load_state_dict``: the packed weight follows the loaded one."""
    module.wq_packed = module._pack()


class Int8Conv2d(nn.Module):
    """int8 replacement of an eligible ``nn.Conv2d`` (JAX ``_conv_int8``).

    NCHW in and out, as the module it replaces; the tensors are
    ``channels_last``, so the NHWC view K4 and K5 take is the same bytes.
    Holds the s8 weight in HWIO, the per-output-channel scales ``ws``, the
    conv's own bias, the folded BN affine (``mult``, ``shift``), the
    calibrated activation scale and, for a chained producer, the
    consumer's scale. With a calibrated scale the epilogue vectors are
    computed once, with the ops and op order of the JAX package. The
    weight in the kernels' layout (``wq_packed``) is made once here too, in
    a buffer that ``state_dict()`` leaves out.
    """

    def __init__(self, conv: nn.Conv2d, wq: torch.Tensor, ws: torch.Tensor,
                 fold: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                 chain: Optional[Tuple[bool, float]] = None,
                 act_scale: Optional[float] = None):
        super().__init__()
        dev = conv.weight.device
        self.in_channels, self.out_channels = conv.in_channels, conv.out_channels
        self.stride = tuple(conv.stride)
        ksize = tuple(conv.kernel_size)
        if isinstance(conv.padding, str):  # torch's "same" is XLA's SAME at stride 1
            self.pads = conv.padding.upper()
            zero_pad = self.pads == "VALID" or ksize == (1, 1)
        else:
            self.pads = tuple((p, p) for p in conv.padding)
            zero_pad = not any(conv.padding)
        #: 1×1 with no border: subsample, then a GEMM (JAX quant.py:371-386)
        self.gemm = ksize == (1, 1) and zero_pad
        self.register_buffer("wq", wq.to(dev).permute(2, 3, 1, 0).contiguous())
        self.register_buffer("wq_packed", self._pack(), persistent=False)
        self.register_load_state_dict_post_hook(_repack)
        self.register_buffer("ws", ws.to(dev, torch.float32))
        self.register_buffer("bias", None if conv.bias is None
                             else conv.bias.detach().float().clone())
        mult, shift = fold if fold is not None else (None, None)
        self.register_buffer("mult", _buffer(mult, dev))
        self.register_buffer("shift", _buffer(shift, dev))
        self.relu, cons_scale = chain if chain is not None else (False, None)
        self.register_buffer("cons_scale", _buffer(cons_scale, dev))
        self.register_buffer("act_scale", _buffer(act_scale, dev))
        scale_vec, bias_vec = (self._affine(self.act_scale) if act_scale is not None
                               else (None, None))
        self.register_buffer("scale_vec", scale_vec)
        self.register_buffer("bias_vec", bias_vec)

    def _pack(self) -> torch.Tensor:
        if self.gemm:
            return pack_weight(self.wq.view(self.in_channels, self.out_channels))
        return pack_conv_weight(self.wq)

    def _affine(self, xs: torch.Tensor):
        """The epilogue's ``(scale, bias)`` vectors, op for op as the JAX
        ``_conv_int8``: ``scale = (xs·ws)·mult / cs`` and ``bias =
        (bias·mult + shift) / cs``, each op rounded on its own."""
        scale, bias = xs * self.ws, self.bias
        if self.mult is not None:
            scale = scale * self.mult
            bias = self.shift if bias is None else bias * self.mult + self.shift
        if self.cons_scale is not None:
            scale = scale / self.cons_scale
            bias = None if bias is None else bias / self.cons_scale
        return scale, bias

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xq, xs = _quantize_act(x, self.act_scale)
        if self.scale_vec is None:
            scale, bias = self._affine(xs)
        else:
            scale, bias = self.scale_vec, self.bias_vec
        kw = dict(scale=scale, bias=bias, relu=self.relu,
                  out_dtype=torch.float32 if self.cons_scale is None else torch.int8)
        xh = xq.permute(0, 2, 3, 1)  # channels_last NCHW → contiguous NHWC
        if self.gemm:
            sh, sw = self.stride
            xsub = xh[:, ::sh, ::sw, :]
            y = int8_gemm(xsub.reshape(-1, self.in_channels),
                          self.wq.view(self.in_channels, self.out_channels),
                          b_packed=self.wq_packed, **kw)
            y = y.view(*xsub.shape[:3], self.out_channels)
        else:
            y = int8_conv2d(xh.contiguous(), self.wq, padding=self.pads,
                            strides=self.stride, w_packed=self.wq_packed, **kw)
        return y.permute(0, 3, 1, 2)


class Int8Linear(nn.Module):
    """int8 replacement of an eligible ``nn.Linear`` (JAX ``_dense_int8``),
    through K4: ``acc·(xs·ws) + bias`` in fp32."""

    def __init__(self, linear: nn.Linear, wq: torch.Tensor, ws: torch.Tensor,
                 act_scale: Optional[float] = None):
        super().__init__()
        dev = linear.weight.device
        self.in_features, self.out_features = linear.in_features, linear.out_features
        self.register_buffer("wq", wq.to(dev).t().contiguous())  # (in, out)
        self.register_buffer("wq_packed", self._pack(), persistent=False)
        self.register_load_state_dict_post_hook(_repack)
        self.register_buffer("ws", ws.to(dev, torch.float32))
        self.register_buffer("bias", None if linear.bias is None
                             else linear.bias.detach().float().clone())
        self.register_buffer("act_scale", _buffer(act_scale, dev))

    def _pack(self) -> torch.Tensor:
        return pack_weight(self.wq)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xq, xs = _quantize_act(x, self.act_scale)
        y = int8_gemm(xq.reshape(-1, self.in_features), self.wq, scale=xs * self.ws,
                      bias=self.bias, out_dtype=torch.float32, b_packed=self.wq_packed)
        return y.reshape(*x.shape[:-1], self.out_features)


def quantize_model(model: nn.Module, config: Optional[QuantConfig] = None,
                   weights: Optional[Dict[str, Tuple[torch.Tensor, torch.Tensor]]] = None
                   ) -> nn.Module:
    """Swap, in place, every eligible ``nn.Conv2d`` / ``nn.Linear`` of
    ``model`` for its int8 module and every folded ``nn.BatchNorm2d`` for
    ``nn.Identity``; returns ``model``. ``weights`` are
    :func:`prequantize_weights`' (computed here when not given). No fp32
    weight of a swapped layer stays in the model (the counterpart of the
    JAX ``make_int8_interceptor`` + ``strip_prequantized``). Its ViTs take
    the int8 token layout (``_int8_layout``)."""
    cfg = config or QuantConfig()
    _int8_layout(model)
    if weights is None:
        weights = prequantize_weights(model, cfg)
    folding = cfg.bn_folding or {}
    fold_convs, fold_bns = folding.get("convs", {}), folding.get("bns", set())
    scales, chains = cfg.act_scales or {}, cfg.int8_chains or {}
    swaps = {}
    for name, mod in model.named_modules():
        if name in fold_bns:
            if mod.training:
                raise ValueError("BN folding is inference-only: BatchNorm "
                                 f"{name} is in training mode")
            swaps[name] = nn.Identity()
        elif _eligible(name, mod, cfg):
            wq, ws = weights[name]
            if isinstance(mod, nn.Conv2d):
                swaps[name] = Int8Conv2d(mod, wq, ws, fold=fold_convs.get(name),
                                         chain=chains.get(name),
                                         act_scale=scales.get(name))
            else:
                swaps[name] = Int8Linear(mod, wq, ws, act_scale=scales.get(name))
    for name, new in swaps.items():
        parent, _, attr = name.rpartition(".")
        setattr(model.get_submodule(parent), attr, new)
    return model


def calibrate_act_scales(model: nn.Module, batches: Sequence[torch.Tensor],
                         config: Optional[QuantConfig] = None) -> Dict[str, float]:
    """Static activation calibration: runs the float ``model`` over
    ``batches`` and returns ``{module name: max|x| / 127}`` over all of
    them for every layer the quantizer would replace (a Python float, as
    the JAX ``calibrate_act_scales`` computes it), with the model's ViTs
    in the int8 token layout (``_int8_layout``), as they serve."""
    cfg = config or QuantConfig()
    _int8_layout(model)
    seen: Dict[str, torch.Tensor] = {}

    def observe(name):
        def hook(mod, args):
            amax = args[0].detach().float().abs().amax()
            seen[name] = amax if name not in seen else torch.maximum(seen[name], amax)
        return hook

    handles = [m.register_forward_pre_hook(observe(n))
               for n, m in _eligible_layers(model, cfg)]
    amaxes: Dict[str, float] = {}
    try:
        with torch.no_grad():
            for batch in batches:
                seen.clear()
                model(batch)
                for k, v in seen.items():
                    amaxes[k] = max(amaxes.get(k, 0.0), float(v))
    finally:
        for h in handles:
            h.remove()
    return {k: max(v, 1e-12) / 127.0 for k, v in amaxes.items()}


def build_bn_folding(model: nn.Module, sample: torch.Tensor,
                     config: Optional[QuantConfig] = None) -> dict:
    """Discover ``Conv → BatchNorm`` pairs and their folded affines.

    Runs the float ``model`` once on ``sample`` with hooks that record, in
    call order, each eligible conv's output tensor and each BN's input
    tensor. A BN folds when it is called right after a conv and its input
    *is* that conv's output (dataflow, not adjacency). With ``f = γ /
    √(var + ε)`` the conv's epilogue takes ``mult = f`` and ``shift = β −
    mean·f``. Returns ``{"convs": {conv name: (mult, shift)}, "bns":
    {bn name, …}}`` for ``QuantConfig(bn_folding=...)``.
    """
    cfg = config or QuantConfig()
    _int8_layout(model)
    events = []
    handles = []
    for name, mod in model.named_modules():
        if isinstance(mod, nn.Conv2d) and _eligible(name, mod, cfg):
            handles.append(mod.register_forward_hook(
                lambda m, args, out, name=name: events.append(("conv", name, m, out))))
        elif isinstance(mod, nn.BatchNorm2d):
            handles.append(mod.register_forward_pre_hook(
                lambda m, args, name=name: events.append(("bn", name, m, args[0]))))
    try:
        with torch.no_grad():
            model(sample)
    finally:
        for h in handles:
            h.remove()
    convs, bns = {}, set()
    for (kind_a, conv_name, conv, conv_out), (kind_b, bn_name, bn, bn_in) in zip(
            events, events[1:]):
        if kind_a != "conv" or kind_b != "bn" or bn_in is not conv_out:
            continue
        if bn.running_mean is None or bn.num_features != conv.out_channels:
            continue
        with torch.no_grad():
            gamma = bn.weight if bn.affine else torch.ones_like(bn.running_mean)
            beta = bn.bias if bn.affine else torch.zeros_like(bn.running_mean)
            # numpy's fp32 sqrt is correctly rounded; torch's CPU one is not
            # (an ulp off on ~1% of values) and its CUDA one is: computed here,
            # the affine is the same bits on the card and the CPU
            var = (bn.running_var.float() + bn.eps).cpu().numpy()
            f = gamma.float() / torch.from_numpy(np.sqrt(var)).to(gamma.device)
            convs[conv_name] = (f, beta.float() - bn.running_mean.float() * f)
        bns.add(bn_name)
    return {"convs": convs, "bns": bns}


def _close(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and bool(torch.allclose(a, b, rtol=1e-4, atol=1e-6))


def build_int8_chains(model: nn.Module, sample: torch.Tensor,
                      act_scales: Dict[str, float],
                      config: Optional[QuantConfig] = None,
                      verify_tol: float = 0.1) -> Dict[str, Tuple[bool, float]]:
    """Discover conv → conv chains where the producer can requantize.

    Runs the float ``model`` on one row of ``sample``, recording every
    eligible conv's input and output in call order; conv A chains to the
    next eligible conv B when B's input equals ``relu(bn_A(A_out))`` (or
    ``bn_A(A_out)``) elementwise. As a guard, the chained int8 model is
    checked end to end against the unchained one on the same row; past a
    relative difference of ``verify_tol`` the chains are dropped (returns
    ``{}``) with a warning. Returns ``{producer name: (relu, consumer
    scale)}`` for ``QuantConfig(int8_chains=...)``.
    """
    cfg = config or QuantConfig()
    _int8_layout(model)
    folding = (cfg.bn_folding or {}).get("convs", {})
    sample = sample[:1]
    records = []
    handles = [m.register_forward_hook(
        lambda mod, args, out, name=n: records.append((name, args[0], out)))
        for n, m in _eligible_layers(model, cfg) if isinstance(m, nn.Conv2d)]
    try:
        with torch.no_grad():
            model(sample)
    finally:
        for h in handles:
            h.remove()

    chains = {}
    for (a_name, _, a_out), (b_name, b_in, _) in zip(records, records[1:]):
        if b_name not in act_scales:
            continue
        t = a_out
        if a_name in folding:
            mult, shift = folding[a_name]
            t = a_out * mult.view(1, -1, 1, 1) + shift.view(1, -1, 1, 1)
        if _close(b_in, torch.relu(t)):
            chains[a_name] = (True, float(act_scales[b_name]))
        elif _close(b_in, t):
            chains[a_name] = (False, float(act_scales[b_name]))
    if not chains:
        return {}

    base = dataclasses.replace(cfg, act_scales=act_scales, int8_chains=None)
    chained = dataclasses.replace(base, int8_chains=chains)
    with torch.no_grad():
        ref = quantize_model(copy.deepcopy(model), base)(sample).float()
        got = quantize_model(copy.deepcopy(model), chained)(sample).float()
    rel = float(torch.linalg.norm(got - ref)) / max(float(torch.linalg.norm(ref)), 1e-12)
    if rel > verify_tol:
        warnings.warn(f"int8 chaining failed end-to-end verification "
                      f"(rel diff {rel:.3f} > {verify_tol}); disabling", stacklevel=2)
        return {}
    return chains
