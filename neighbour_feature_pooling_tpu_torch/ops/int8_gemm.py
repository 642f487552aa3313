"""int8 GEMM on the GPU: the CUDA kernel K4 and its plain version.

Counterpart of ``neighbour_feature_pooling_tpu/ops/int8_gemm.py``.
``int8_gemm`` wraps ``csrc/int8_gemm.cu`` (K4), the Hopper port of the TPU
kernels ``_gemm_kernel`` / ``_gemm_kernel_fused``: ``(M, K) s8 × (K, N) s8
→ (M, N) s32``, or with ``scale`` the fused dequant epilogue
(``common.dequant_epilogue``) in fp32 or requantized s8. On a CPU tensor it
runs the plain version, ``int8_gemm_reference``; on a CUDA tensor it
launches K4 or raises. Tile sizes are the kernel's own business: the JAX
``tiles=`` argument and its v5e heuristic have no counterpart.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from . import _build
from .common import dequant_epilogue

__all__ = ["int8_gemm", "int8_gemm_reference"]

# keep in sync with OutKind in csrc/int8_epilogue.cuh
OUT_KINDS = {torch.int32: 0, torch.float32: 1, torch.int8: 2}


def epilogue_operands(scale: Optional[torch.Tensor], bias: Optional[torch.Tensor],
                      out_dtype: Optional[torch.dtype], n: int
                      ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor], torch.dtype]:
    """Check the epilogue arguments of an int8 kernel with ``n`` output
    columns: returns ``scale`` and ``bias`` as fp32 vectors of length
    ``n`` and the output dtype (int32 without ``scale``, as in JAX, where
    ``out_dtype`` and ``relu`` are then unused; else fp32 by default)."""
    if scale is None:
        if bias is not None:
            raise ValueError("bias requires scale (the fused epilogue); the "
                             "s32 form returns the raw accumulator")
        return None, None, torch.int32
    out_dtype = out_dtype or torch.float32
    if out_dtype not in (torch.float32, torch.int8):
        raise TypeError(f"the int8 epilogue emits float32 or int8, not {out_dtype}")
    vecs = []
    for name, v in (("scale", scale), ("bias", bias)):
        if v is not None:
            v = v.reshape(-1).to(torch.float32).contiguous()
            if v.numel() != n:
                raise ValueError(f"{name} has {v.numel()} values for {n} output columns")
        vecs.append(v)
    return vecs[0], vecs[1], out_dtype


def cuda_operands(kernel: str, *tensors: Optional[torch.Tensor]) -> None:
    """Raise unless every given tensor is contiguous and on the first
    one's CUDA device."""
    device = tensors[0].device
    for t in tensors:
        if t is None:
            continue
        if t.device != device:
            raise ValueError(f"{kernel}: operands on {t.device} and {device}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel} needs contiguous operands")


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


@functools.lru_cache(maxsize=None)
def _library_fn():
    fn = _build.load_library("int8_gemm").int8_gemm_forward
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def int8_gemm_reference(a: torch.Tensor, b: torch.Tensor,
                        scale: Optional[torch.Tensor] = None,
                        bias: Optional[torch.Tensor] = None,
                        out_dtype: Optional[torch.dtype] = None,
                        relu: bool = False) -> torch.Tensor:
    """Plain version of ``int8_gemm`` on any device. The product runs in
    float64, which is exact here (|acc| ≤ 127²·K < 2⁵³), and is rounded
    to int32: neither CUDA nor every CPU build has an integer matmul."""
    scale, bias, out_dtype = epilogue_operands(scale, bias, out_dtype, b.shape[1])
    acc = torch.matmul(a.double(), b.double()).round().to(torch.int32)
    if scale is None:
        return acc
    return dequant_epilogue(acc, scale, bias, out_dtype, relu)


def int8_gemm(a: torch.Tensor, b: torch.Tensor,
              scale: Optional[torch.Tensor] = None,
              bias: Optional[torch.Tensor] = None,
              out_dtype: Optional[torch.dtype] = None,
              relu: bool = False) -> torch.Tensor:
    """``(M, K) int8 × (K, N) int8 → (M, N) int32`` (K4, ``csrc/int8_gemm.cu``).

    ``scale`` (per-N fp32, typically ``act_scale · weight_scales``) fuses
    the dequant epilogue: the result is ``acc·scale + bias``, then ReLU
    when ``relu``, in ``out_dtype`` (fp32 by default; int8 requantizes
    with a saturating round). Any M, N and K. On a CUDA input the operands
    must be contiguous and on one device. ``int8_gemm.launches`` counts
    kernel launches.
    """
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError(f"int8_gemm needs int8 operands, got {a.dtype}/{b.dtype}")
    if a.ndim != 2 or b.ndim != 2:
        raise ValueError(f"int8_gemm takes 2-D operands, got {tuple(a.shape)} x {tuple(b.shape)}")
    m, k = a.shape
    k2, n = b.shape
    if k != k2:
        raise ValueError(f"contraction mismatch: {tuple(a.shape)} x {tuple(b.shape)}")
    if a.device.type == "cpu":
        return int8_gemm_reference(a, b, scale, bias, out_dtype, relu)
    if a.device.type != "cuda":
        raise ValueError(f"int8_gemm takes a CUDA or CPU tensor, got {a.device}")
    scale, bias, out_dtype = epilogue_operands(scale, bias, out_dtype, n)
    cuda_operands("int8_gemm", a, b, scale, bias)
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    if m == 0 or n == 0:  # an empty grid is not a valid launch
        return out
    vec = int(k % 16 == 0 and a.data_ptr() % 16 == 0)
    with torch.cuda.device(a.device):
        rc = _library_fn()(
            a.data_ptr(), b.data_ptr(), ptr(scale), ptr(bias), out.data_ptr(),
            m, n, k, OUT_KINDS[out_dtype], int(bool(relu)), vec,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"int8_gemm kernel launch failed: cudaError_t {rc}")
    int8_gemm.launches += 1
    return out


int8_gemm.launches = 0
