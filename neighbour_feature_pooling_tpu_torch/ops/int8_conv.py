"""int8 convolution on the GPU: the CUDA kernel K5 and its plain version.

Counterpart of ``neighbour_feature_pooling_tpu/ops/int8_conv.py``.
``int8_conv2d`` wraps ``csrc/int8_conv.cu`` (K5), the Hopper port of the
TPU kernels ``_conv_kernel`` / ``_conv_kernel_fused``: an NHWC s8 ⊛ HWIO s8
conv with exact s32 accumulation, any stride and padding, and the fused
dequant epilogue of ``int8_gemm``. The layouts are the JAX package's. On a
CPU tensor it runs the plain version, ``int8_conv2d_reference``; on a CUDA
tensor it launches K5 or raises. K5 applies the stride and the zero
padding in its index math, so the TPU kernel's flattened-row layout, host
padding and space-to-depth rewrite (and their ``batch_tile`` / ``tcout``
tiling arguments) have no counterpart. K5 reads the weight packed
(``pack_conv_weight``), and an RGB input with a zero fourth channel, so
that one pixel's tap is one aligned 4-byte word.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from . import _build
from .common import dequant_epilogue
from .int8_gemm import (OUT_KINDS, _tile_plan, a_mode, cuda_operands, epilogue_operands,
                        check_packed, pack_weight, ptr, sm_count)

__all__ = ["int8_conv2d", "int8_conv2d_reference", "pack_conv_weight"]

Padding = Union[str, Sequence[Tuple[int, int]]]


def _resolve_pads(padding: Padding, kh: int, kw: int, h: int, wdt: int,
                  strides: Tuple[int, int]) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """Padding spec → explicit ``((top, bottom), (left, right))``, with
    XLA's SAME convention under strides (``lo = floor``, ``hi = ceil`` of
    the deficit). A copy of the JAX ``int8_conv._resolve_pads``."""
    if isinstance(padding, str):
        name = padding.upper()
        if name in ("SAME", "SAME_LOWER"):
            pads = []
            for dim, k, s in ((h, kh, strides[0]), (wdt, kw, strides[1])):
                out = -(-dim // s)                       # ceil
                total = max((out - 1) * s + k - dim, 0)
                lo = total // 2 if name == "SAME" else total - total // 2
                pads.append((lo, total - lo))
            return tuple(pads)
        if name == "VALID":
            return ((0, 0), (0, 0))
        raise ValueError(f"unsupported padding {padding!r}")
    return tuple((int(lo), int(hi)) for lo, hi in padding)


def _geometry(x: torch.Tensor, w: torch.Tensor, padding: Padding,
              strides: Sequence[int]):
    """Check the operands; returns the pads, strides and output size."""
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"int8_conv2d needs int8 operands, got {x.dtype}/{w.dtype}")
    if x.ndim != 4 or w.ndim != 4:
        raise ValueError(f"NHWC x HWIO expected, got {tuple(x.shape)}/{tuple(w.shape)}")
    _, h, wdt, cin = x.shape
    kh, kw, cin2, _ = w.shape
    if cin != cin2:
        raise ValueError(f"Cin mismatch: {tuple(x.shape)} vs {tuple(w.shape)}")
    strides = (int(strides[0]), int(strides[1]))
    if min(strides) < 1:
        raise ValueError(f"strides must be positive, got {strides}")
    pads = _resolve_pads(padding, kh, kw, h, wdt, strides)
    if min(min(p) for p in pads) < 0:
        raise ValueError(f"negative padding {pads} is not supported")
    ho = (h + pads[0][0] + pads[0][1] - kh) // strides[0] + 1
    wo = (wdt + pads[1][0] + pads[1][1] - kw) // strides[1] + 1
    if ho <= 0 or wo <= 0:
        raise ValueError("empty output")
    return pads, strides, ho, wo


@functools.lru_cache(maxsize=None)
def _library_fn():
    fn = _build.load_library("int8_conv").int8_conv_forward
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 17 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _kernel_cin(cin: int) -> int:
    """The input channels K5 is given: an RGB image gets a zero fourth."""
    return 4 if cin == 3 else cin


def pack_conv_weight(w: torch.Tensor) -> torch.Tensor:
    """An HWIO s8 weight in the layout K5 reads: ``pack_weight`` of its
    ``(kh·kw·Cin, Cout)`` view, a Cin of 3 first zero-padded to 4 (the
    same sums: the fourth channel adds zeros). On any device."""
    kh, kw, cin, cout = w.shape
    w = F.pad(w, (0, 0, 0, _kernel_cin(cin) - cin))
    return pack_weight(w.reshape(-1, cout))


def int8_conv2d_reference(x: torch.Tensor, w: torch.Tensor, padding: Padding = "SAME",
                          strides: Sequence[int] = (1, 1),
                          scale: Optional[torch.Tensor] = None,
                          bias: Optional[torch.Tensor] = None,
                          out_dtype: Optional[torch.dtype] = None,
                          relu: bool = False) -> torch.Tensor:
    """Plain version of ``int8_conv2d`` on any device. The conv runs in
    float64, which is exact here (|acc| ≤ 127²·Kh·Kw·Cin < 2⁵³), and is
    rounded to int32: CUDA has no integer conv."""
    pads, strides, _, _ = _geometry(x, w, padding, strides)
    scale, bias, out_dtype = epilogue_operands(scale, bias, out_dtype, w.shape[3])
    xd = F.pad(x.permute(0, 3, 1, 2).double(),
               (pads[1][0], pads[1][1], pads[0][0], pads[0][1]))
    acc = F.conv2d(xd, w.permute(3, 2, 0, 1).double(), stride=strides)
    acc = acc.round().to(torch.int32).permute(0, 2, 3, 1).contiguous()
    if scale is None:
        return acc
    return dequant_epilogue(acc, scale, bias, out_dtype, relu)


def int8_conv2d(x: torch.Tensor, w: torch.Tensor, padding: Padding = "SAME",
                strides: Sequence[int] = (1, 1),
                scale: Optional[torch.Tensor] = None,
                bias: Optional[torch.Tensor] = None,
                out_dtype: Optional[torch.dtype] = None,
                relu: bool = False,
                w_packed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``(B,H,W,Cin) s8 ⊛ (Kh,Kw,Cin,Cout) s8 → (B,Ho,Wo,Cout) s32``
    (K5, ``csrc/int8_conv.cu``).

    One group, no dilation. ``padding`` is ``"SAME"``, ``"VALID"`` or
    explicit ``((top, bottom), (left, right))``; any strides. ``scale``
    (per-Cout fp32) fuses the dequant epilogue as in ``int8_gemm``: the
    result is ``acc·scale + bias``, ReLU when ``relu``, in ``out_dtype``
    (fp32 by default; int8 requantizes). On a CUDA input the operands must
    be contiguous and on one device. K5 reads ``pack_conv_weight(w)``: pass
    it as ``w_packed`` when ``w`` is constant, else the CUDA path packs in
    the call (two more torch ops per call); with Cin = 3 it also pads ``x``
    to four channels (one more). On a CPU input ``w_packed`` is ignored.
    ``int8_conv2d.launches`` counts kernel launches,
    ``int8_conv2d.s8_launches`` those that emit int8.
    """
    pads, strides, ho, wo = _geometry(x, w, padding, strides)
    if x.device.type == "cpu":
        return int8_conv2d_reference(x, w, pads, strides, scale, bias, out_dtype, relu)
    if x.device.type != "cuda":
        raise ValueError(f"int8_conv2d takes a CUDA or CPU tensor, got {x.device}")
    b, h, wdt, cin = x.shape
    kh, kw, _, cout = w.shape
    scale, bias, out_dtype = epilogue_operands(scale, bias, out_dtype, cout)
    kcin = _kernel_cin(cin)
    if w_packed is None:
        w_packed = pack_conv_weight(w)
    check_packed("int8_conv2d", w_packed, kh * kw * kcin, cout)
    cuda_operands("int8_conv2d", x, w_packed, scale, bias)
    if kcin != cin:
        x = F.pad(x, (0, kcin - cin))
    out = torch.empty((b, ho, wo, cout), dtype=out_dtype, device=x.device)
    if out.numel() == 0:  # an empty grid is not a valid launch
        return out
    with torch.cuda.device(x.device):
        rc = _library_fn()(
            x.data_ptr(), w_packed.data_ptr(), ptr(scale), ptr(bias), out.data_ptr(),
            b, h, wdt, kcin, cout, kh, kw, strides[0], strides[1],
            pads[0][0], pads[1][0], ho, wo, OUT_KINDS[out_dtype], int(bool(relu)),
            a_mode(kcin, x.data_ptr()),
            _tile_plan(b * ho * wo, cout, kh * kw * kcin, sm_count(x.device)),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"int8_conv kernel launch failed: cudaError_t {rc}")
    int8_conv2d.launches += 1
    int8_conv2d.s8_launches += out_dtype == torch.int8
    return out


int8_conv2d.launches = 0
int8_conv2d.s8_launches = 0
