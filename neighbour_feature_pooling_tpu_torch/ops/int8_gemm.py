"""int8 GEMM on the GPU: the CUDA kernel K4 and its plain version.

Counterpart of ``neighbour_feature_pooling_tpu/ops/int8_gemm.py``.
``int8_gemm`` wraps ``csrc/int8_gemm.cu`` (K4), the Hopper port of the TPU
kernels ``_gemm_kernel`` / ``_gemm_kernel_fused``: ``(M, K) s8 × (K, N) s8
→ (M, N) s32``, or with ``scale`` the fused dequant epilogue
(``common.dequant_epilogue``) in fp32 or requantized s8. On a CPU tensor it
runs the plain version, ``int8_gemm_reference``; on a CUDA tensor it
launches K4 or raises. The operands keep the JAX layouts; the kernels read
the weight in their own, ``pack_weight``'s, which a caller with a constant
weight makes once and passes as ``b_packed``. The tile size is chosen here
from the shape (``_tile_plan``): the JAX ``tiles=`` argument and its v5e
heuristic have no counterpart.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build
from .common import dequant_epilogue

__all__ = ["int8_gemm", "int8_gemm_reference", "pack_weight"]

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


def pack_weight(w: torch.Tensor) -> torch.Tensor:
    """A ``(K, N)`` s8 weight (a conv's HWIO one viewed as ``(kh·kw·Cin,
    Cout)``) in the layout K4 and K5 read: ``(N, Kp)``, k contiguous, ``Kp``
    = K rounded up to 16, zero filled. On any device."""
    if w.dtype != torch.int8 or w.ndim != 2:
        raise TypeError(f"pack_weight takes a 2-D int8 weight, got {w.dtype} {tuple(w.shape)}")
    return F.pad(w.t(), (0, -w.shape[0] % 16)).contiguous()


def check_packed(kernel: str, packed: torch.Tensor, k: int, n: int) -> None:
    """Raise unless ``packed`` has the type and shape of a packed
    ``(k, n)`` weight."""
    if packed.dtype != torch.int8 or tuple(packed.shape) != (n, k + -k % 16):
        raise ValueError(f"{kernel}: packed weight {packed.dtype} {tuple(packed.shape)} does "
                         f"not belong to a ({k}, {n}) weight (pack_weight gives "
                         f"({n}, {k + -k % 16}) int8)")


def a_mode(run: int, address: int) -> int:
    """How the kernels move A to shared memory (``AMode`` in
    csrc/int8_mma.cuh): 2 = 16-byte chunks, 1 = 4-byte words, 0 = bytes.
    ``run`` is the length of the contiguous runs of k in A (K for a GEMM,
    Cin for a conv), ``address`` its base address."""
    for mode, size in ((2, 16), (1, 4)):
        if run % size == 0 and address % size == 0:
            return mode
    return 0


def _tile_plan(m: int, n: int, k: int, sms: int = 132) -> int:
    """The tile id of an ``(m, k) × (k, n)`` product: 0 = 128×64 tiles, 1 =
    64×64 when the 128×64 grid has fewer than two blocks per SM (at B=32
    ResNet18's layer3, layer4 and the two small downsample GEMMs). ``sms``
    is the card's SM count (an H100's by default; the wrappers pass their
    device's). ``k`` does not enter: there is no split over K."""
    blocks = -(-m // 128) * -(-n // 64)
    return int(blocks < 2 * sms)


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=None)
def _library_fn():
    fn = _build.load_library("int8_gemm").int8_gemm_forward
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
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
              relu: bool = False,
              b_packed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``(M, K) int8 × (K, N) int8 → (M, N) int32`` (K4, ``csrc/int8_gemm.cu``).

    ``scale`` (per-N fp32, typically ``act_scale · weight_scales``) fuses
    the dequant epilogue: the result is ``acc·scale + bias``, then ReLU
    when ``relu``, in ``out_dtype`` (fp32 by default; int8 requantizes
    with a saturating round). Any M, N and K. On a CUDA input the operands
    must be contiguous and on one device. K4 reads ``pack_weight(b)``:
    pass it as ``b_packed`` when ``b`` is constant, else the CUDA path
    packs in the call (one more torch op per call). On a CPU input
    ``b_packed`` is ignored. ``int8_gemm.launches`` counts kernel launches,
    ``int8_gemm.s8_launches`` those that emit int8.
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
    if b_packed is None:
        b_packed = pack_weight(b)
    check_packed("int8_gemm", b_packed, k, n)
    cuda_operands("int8_gemm", a, b_packed, scale, bias)
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    if m == 0 or n == 0:  # an empty grid is not a valid launch
        return out
    with torch.cuda.device(a.device):
        rc = _library_fn()(
            a.data_ptr(), b_packed.data_ptr(), ptr(scale), ptr(bias), out.data_ptr(),
            m, n, k, OUT_KINDS[out_dtype], int(bool(relu)), a_mode(k, a.data_ptr()),
            _tile_plan(m, n, k, sm_count(a.device)),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"int8_gemm kernel launch failed: cudaError_t {rc}")
    int8_gemm.launches += 1
    int8_gemm.s8_launches += out_dtype == torch.int8
    return out


int8_gemm.launches = 0
int8_gemm.s8_launches = 0
