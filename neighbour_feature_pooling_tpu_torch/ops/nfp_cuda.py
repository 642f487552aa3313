"""Neighborhood Feature Pooling on the GPU: the CUDA kernels and the public op.

Counterpart of ``neighbour_feature_pooling_tpu/ops/nfp_pallas.py``.

* ``nfp_small_cuda`` wraps ``csrc/nfp_small.cu`` (K1), the Hopper port of
  the small-map TPU kernel ``_nfp_kernel_unrolled`` (maps of at most 256
  output positions, stride 1, every stat-free measure, optional fused GAP).
* ``nfp_large_cuda`` wraps ``csrc/nfp_large.cu`` (K2), the Hopper port of
  the large-map TPU kernel ``_nfp_kernel_chw`` (any map size, stride 1, the
  separable measures of ``measures.SEPARABLE``, optional fused GAP).
* ``nfp_strip_cuda`` wraps ``csrc/nfp_strip.cu`` (K3), the Hopper port of
  the strip-mined NHWC TPU kernel ``_nfp_kernel`` (any map size, stride 1,
  every stat-free measure, ``pearson`` included, optional fused GAP). K2
  and K3 are instances of one kernel template, ``csrc/nfp_strips.cuh``, cut
  by one plan, ``_k2_plan``.
* On a CPU tensor each wrapper runs the plain version,
  ``neighborhood.nfp_reference``; on a CUDA tensor it launches its kernel
  or raises.
* ``nfp`` dispatches as the JAX ``nfp`` does (``_forward_value``): a CUDA
  input goes to K1 or K2 where the JAX package sends it to the matching
  Pallas kernel; a configuration the JAX package sends to its XLA oracle
  goes to ``nfp_reference`` on either device; a CPU input runs
  ``nfp_reference``.
* ``nfp_kernel`` is the direct kernel entry, the counterpart of the JAX
  ``nfp_pallas``: it sends every stat-free configuration to a kernel, as
  ``nfp_pallas`` picks its body (``_kernel_route``), and is the only path
  that reaches K3.

There is no fallback: a CUDA input a kernel should take either launches it
or raises. Gradients: ``nfp`` on a CUDA input that requires grad runs its
kernel inside an ``autograd.Function`` (``_KernelForward``) whose backward
recomputes the plain version on the saved input and differentiates it, the
recipe of the JAX ``_nfp_bwd`` (``jax.vjp`` of the XLA oracle); the
backward launches no kernel. The kernel wrappers themselves have no
backward and raise on an input that needs one.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build
from .measures import get_measure, get_separable
from .neighborhood import PAD_MODES, nfp_output_size, nfp_reference, num_neighbors

__all__ = ["nfp", "nfp_kernel", "nfp_small_cuda", "nfp_large_cuda", "nfp_strip_cuda",
           "kernel_supported"]

#: dispatch thresholds of the JAX ``nfp`` (nfp_pallas.py:433-439), kept so
#: both packages route every configuration the same way; they were chosen
#: on a TPU and are still to be re-derived for this card
_MAX_POSITIONS = 256
_CHW_MAX_CHANNELS = 48
_CHW_GAP_MAX_CHANNELS = 64

# keep in sync with the enums in csrc/nfp_measures.cuh
_MEASURE_IDS = {name: i for i, name in enumerate((
    "norm", "cosine", "dot", "rmse", "geman", "emd", "canberra", "hellinger",
    "chisquared1", "chisquared2", "gfc", "pearson", "jeffrey", "squaredchord",
    "smith", "scs"))}
_FINALIZE_IDS = {"neg_if_sim": 0, "neg_if_dist": 1, "one_minus_if_dist": 2}
#: K1's block size (``csrc/nfp_small.cu::kThreads``), the most row tiles an
#: image is cut into (one thread-block cluster, 8 at most where portable),
#: and the shared memory a K1 block may take: two blocks fit on one SM
#: (228 KB, 1 KB of it reserved per block)
_K1_THREADS = 256
_K1_MAX_TILES = 8
_K1_SMEM_BUDGET = 112 * 1024


class K1Plan(NamedTuple):
    """How K1 cuts one launch: ``rows`` output rows per block, ``n_tiles``
    blocks per image, ``chunk`` channels staged at a time, ``group`` lanes
    per (position, neighbour) pair, and the most shared memory a block
    takes (``smem_bytes``, any measure)."""
    rows: int
    n_tiles: int
    chunk: int
    group: int
    smem_bytes: int


def _align16(n: int) -> int:
    return -(-n // 16) * 16


def _k1_smem_bytes(rows, chunk, C, Wo, radius, dilation, elem_bytes) -> int:
    """Shared memory of one K1 block in its largest case, ``pearson`` with
    the fused GAP (``csrc/nfp_small.cu::smem_layout``): the staged window,
    the pixel means, the per-pair chunk accumulators, the pair values and
    the window's source rows and columns."""
    k = 2 * radius + 1
    span = (k - 1) * dilation
    n_pix = (rows + span) * (Wo + span)
    n_pairs = rows * Wo * (k * k - 1)
    return (_align16(n_pix * chunk * elem_bytes) + _align16(n_pix * 4)
            + (_align16(n_pairs * 12) if C // chunk > 1 else 0)
            + _align16(n_pairs * 4) + _align16((rows + span + Wo + span) * 4))


def _k1_plan(B, H, W, C, Ho, Wo, radius, dilation, dtype) -> K1Plan:
    """K1's cut of a (B, H, W, C) map with an Ho × Wo output.

    * ``rows``: as many row tiles per image as the cap of 8 allows, so the
      most blocks B gives (7 tiles of 1 row at 7², 7 of 2 rows at 14²):
      taller tiles were slower on the H100 even at B=128, where the grid
      needs several waves (PERF.md §6).
    * ``chunk``: all C channels where the window fits the 112 KB budget,
      else the largest divisor of C that fits (a multiple of the 16-byte
      vector where C is one), so every chunk is full.
    * ``group``: the largest power of two from 4 to 32 whose groups still
      take all of a block's pairs in one round, and no more than a pixel's
      16-byte vectors (channels, where C has no whole vectors); 4 where no
      size does. Fewer lanes per pair means fewer shuffle steps.
    """
    del B, H, W  # the window depends on the output map and the padding only
    vec = 4 if dtype == torch.float32 else 8  # elements per 16 bytes
    rows = -(-Ho // min(_K1_MAX_TILES, Ho))
    n_tiles = -(-Ho // rows)
    chunk, smem = _k1_chunk(rows, C, Wo, radius, dilation, dtype)
    units = chunk // vec if C % vec == 0 else chunk
    pairs = rows * Wo * ((2 * radius + 1) ** 2 - 1)
    fits = [g for g in (4, 8, 16, 32)
            if g <= max(4, units) and pairs <= _K1_THREADS // g]
    return K1Plan(rows, n_tiles, chunk, max(fits, default=4), smem)


def _k1_chunk(rows, C, Wo, radius, dilation, dtype):
    """The largest divisor of C whose ``rows``-row window fits K1's shared
    memory budget (a multiple of the 16-byte vector where C is one), and
    the shared memory it takes."""
    vec = 4 if dtype == torch.float32 else 8  # elements per 16 bytes
    elem = 4 if dtype == torch.float32 else 2
    for n in range(1, C + 1):
        chunk = C // n
        if C % n or (C % vec == 0 and chunk % vec):
            continue
        smem = _k1_smem_bytes(rows, chunk, C, Wo, radius, dilation, elem)
        if smem <= _K1_SMEM_BUDGET:
            return chunk, smem
    raise ValueError(f"nfp_small_cuda: no channel chunk of C={C} fits a "
                     f"{rows}-row window of a {Wo}-wide map in shared memory")


#: K2's and K3's block size (``csrc/nfp_strips.cuh::kThreads``), the
#: centre-pixel floats one lane holds in registers (``kLaneFloats``), the
#: shared memory a block may take (the most that lets two blocks share an
#: SM, as their ≤128 registers a thread allow: (228 KB − 1 KB reserved per
#: block) / 2), the blocks a launch should give the card (three for every
#: two of the H100's 132 SMs) and the most steps of rows a block takes
_K2_THREADS = 256
_K2_LANE_FLOATS = 16
_K2_SMEM_BUDGET = 113 * 1024
_K2_MIN_BLOCKS = 198
_K2_MAX_ITERS = 4


class K2Plan(NamedTuple):
    """How K2 and K3 cut one launch: ``rows`` output rows per block, taken
    ``step`` rows at a time, over ``cols`` output columns (``n_strips`` ×
    ``n_cols`` blocks per image), ``chunk`` channels staged at a time,
    ``group`` lanes per output position, ``stride`` 16-byte vectors per
    staged pixel, and the shared memory a block takes (``smem_bytes``)."""
    rows: int
    step: int
    cols: int
    n_strips: int
    n_cols: int
    chunk: int
    group: int
    stride: int
    smem_bytes: int


def _k2_smem_bytes(rows, step, cols, stride, radius, dilation, pixel_floats=1) -> int:
    """Shared memory of one K2 or K3 block (``csrc/nfp_strips.cuh::smem_layout``):
    the ring of staged window rows (an iteration's ``step`` + span rows, and
    the next iteration's ``step`` while they load), ``pixel_floats`` floats
    per ring pixel (its tail; ``pearson`` also keeps its mean), an
    iteration's pair values, the window's source rows and columns, the
    neighbour offsets, the block's GAP sums and a flag."""
    k = 2 * radius + 1
    span = (k - 1) * dilation
    n_pix = ((2 * step if rows > step else step) + span) * (cols + span)
    return (n_pix * stride * 16 + pixel_floats * _align16(n_pix * 4)
            + _align16(step * cols * (k * k - 1) * 4)
            + _align16((rows + span + cols + span + 3 * (k * k - 1) + 1) * 4))


def _k2_pixel_floats(measure) -> int:
    """Floats K2 and K3 keep per staged pixel for ``measure``: its tail, and
    for ``pearson`` also its channel mean."""
    return 2 if get_measure(measure).name == "pearson" else 1


def _k2_stride(units, group):
    """The staged pixel stride, in 16-byte vectors, of a pixel of ``units``
    vectors read by ``group`` lanes: at least ``units`` and, below 8 lanes,
    ``group`` times an odd number, so that the 8 lanes of a quarter-warp
    read 8 distinct 16-byte bank groups."""
    stride = units
    while group < 8 and stride % (2 * group) != group:
        stride += 1
    return stride


def _k2_plan(B, H, W, C, Ho, Wo, radius, dilation, dtype, measure="cosine") -> K2Plan:
    """K2's and K3's cut of a (B, H, W, C) map with an Ho × Wo output for
    ``measure``, which sets the floats kept per staged pixel (two for
    ``pearson``: its mean and centred sum of squares; one otherwise).

    * ``chunk``: all C channels where a one-row full-width strip fits the
      113 KB budget and a lane's registers (16 floats, at most 32 lanes), else
      the largest divisor of C that does (a multiple of the 16-byte vector
      where C is one), so every chunk is full.
    * ``group``: the fewest lanes per position (a power of two up to 32)
      whose registers hold the chunk's centre pixel, 16 floats a lane: 1 at
      C=16 fp32, 2 at C=24, 4 at C=40; fewer lanes means fewer shuffle
      steps per pair. ``stride``: ``_k2_stride``.
    * ``cols``: the full width ``Wo``; column tiles only where even a
      one-row step of the smallest chunk exceeds the budget.
    * ``step``: among the steps that fit the budget and, one step a block,
      still give the card 1.5 blocks per SM at this B, the shortest whose
      positions fill 1.5 rounds of the block's lane groups (the longest
      where none does; 1 row where no step gives that many blocks): 4 rows
      at the MobileNetV3 taps 112², 56² and 28² at B = 32 and 128.
    * ``rows``: ``step`` times the most iterations (up to 4) that keep 1.5
      blocks per SM and fit the budget with the next step's rows loading
      while a step computes; always one iteration with a chunked C (each
      chunk is a pass over the block's rows). At B=32: 16, 8 and 4 rows at
      the taps, 224 blocks each; at B=128, 16 rows.

    The constants come from ``tools/sweep_k2_plan.py`` on the H100 (PERF.md
    §6): longer steps and fewer, longer-lived blocks won at every
    B=32 and B=128 tap, down to 224 blocks at B=32 (1.7 a SM; 448 blocks
    were 7–12% slower), and the fewest lanes per position won everywhere.
    With ``pearson`` (``--measure pearson``) the same held; its 16-row
    blocks at 112², which need the full two-block share of 113 KB for the
    pixel means, beat 4-row ones by 15%.
    """
    del H, W  # the window depends on the output map and the padding only
    vec = 4 if dtype == torch.float32 else 8  # elements per 16 bytes
    pixel_floats = _k2_pixel_floats(measure)
    slots = _K2_LANE_FLOATS // vec  # 16-byte vectors a lane holds
    chunks = [C // n for n in range(1, C + 1)
              if C % n == 0 and not (C % vec == 0 and (C // n) % vec)
              and -(-(C // n) // vec) <= 32 * slots]
    cols = Wo
    while True:
        for chunk in chunks:
            units = -(-chunk // vec)
            group = next(g for g in (1, 2, 4, 8, 16, 32) if -(-units // g) <= slots)
            stride = _k2_stride(units, group)
            fits = [st for st in range(1, Ho + 1) if _k2_smem_bytes(
                st, st, cols, stride, radius, dilation, pixel_floats) <= _K2_SMEM_BUDGET]
            if fits:
                break
        if fits or cols == 1:
            break
        cols = -(-cols // 2)
    if not fits:
        raise ValueError(f"no strip of a {Wo}-wide map with C={C} fits the shared memory "
                         f"budget of K2 and K3")
    n_cols = -(-Wo // cols)
    n_groups = _K2_THREADS // group

    def blocks(r):
        return -(-Ho // r) * n_cols * B

    busy = [st for st in fits if blocks(st) >= _K2_MIN_BLOCKS]
    step = next((st for st in busy if 2 * st * cols >= 3 * n_groups), busy[-1]) if busy else 1
    iters = [n for n in range(2, min(_K2_MAX_ITERS, -(-Ho // step)) + 1)
             if blocks(n * step) >= _K2_MIN_BLOCKS and _k2_smem_bytes(
                 n * step, step, cols, stride, radius, dilation,
                 pixel_floats) <= _K2_SMEM_BUDGET]
    rows = step * (max(iters) if iters and chunk == C else 1)
    return K2Plan(rows, step, cols, -(-Ho // rows), n_cols, chunk, group, stride,
                  _k2_smem_bytes(rows, step, cols, stride, radius, dilation, pixel_floats))


def kernel_supported(measure: str, stride: int) -> bool:
    """The kernels cover stride 1 and every stat-free measure."""
    return get_measure(measure).name != "mahalanobis" and stride == 1


#: the pointers each kernel's C entry takes first, and the plan integers it
#: takes after the common arguments
_POINTERS = {"nfp_small": 2, "nfp_large": 4, "nfp_strip": 4}
_PLAN_INTS = {"nfp_small": 3, "nfp_large": 6, "nfp_strip": 6}


@functools.lru_cache(maxsize=None)
def _library_fn(name: str):
    """``<name>_forward`` of ``csrc/<name>.cu`` with its ctypes signature:
    K1 takes its plan (rows, chunk, group) and reduces its fused GAP within
    one launch; K2 and K3 take their plan (rows, step, cols, chunk, group,
    stride), a partial-sum buffer and arrival counters, and reduce their
    fused GAP within one launch too."""
    lib = _build.load_library(name)
    fn = getattr(lib, f"{name}_forward")
    fn.argtypes = ([ctypes.c_void_p] * _POINTERS[name]
                   + [ctypes.c_int] * 16 + [ctypes.c_float] * 3
                   + [ctypes.c_int] * _PLAN_INTS[name] + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


_ARRIVALS = {}


def _arrival_counters(device, batch):
    """K2's and K3's arrival counters for the current stream of ``device``: ``batch``
    or more int32 zeros, kept between launches (each launch's last block per
    image resets its counter), one buffer per stream so that launches on two
    streams never share one."""
    stream = torch.cuda.current_stream(device).cuda_stream
    key = (device.index, stream)
    buf = _ARRIVALS.get(key)
    if buf is None or buf.numel() < batch:
        buf = _ARRIVALS[key] = torch.zeros(max(batch, 128), dtype=torch.int32, device=device)
    return buf


def _launch(name, x, radius, m, *, similarity, p, eps, q_scs, padding,
            dilation, padding_mode, fuse_gap, max_positions=None):
    """Check a CUDA input and launch ``csrc/<name>.cu`` on it.

    Returns the kernel's output in the input dtype. Raises on anything the
    kernel does not take; never falls back to the plain version."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}_cuda takes a CUDA or CPU tensor, got {x.device}")
    if x.ndim != 4:
        raise ValueError(f"nfp expects a 4-D NHWC map, got shape {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}_cuda takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name}_cuda needs a contiguous NHWC tensor")
    if torch.is_grad_enabled() and x.requires_grad:
        raise NotImplementedError(
            f"{name}_cuda has no backward: differentiate through ops.nfp, whose "
            "autograd.Function runs this kernel forward and the plain version "
            "backward")
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
    if max_positions is not None and h_out * w_out > max_positions:
        raise ValueError(f"{name}_cuda takes maps of at most {max_positions} "
                         f"output positions, got {h_out}x{w_out}")
    n = num_neighbors(radius)
    out = torch.empty((b, n) if fuse_gap else (b, h_out, w_out, n),
                      dtype=torch.float32, device=x.device)
    if b == 0:  # an empty grid is not a valid launch
        return out.to(x.dtype)
    ptrs, plan = [x.data_ptr(), out.data_ptr()], ()
    if name == "nfp_small":
        k1 = _k1_plan(b, h, w, c, h_out, w_out, radius, dilation, x.dtype)
        plan = (k1.rows, k1.chunk, k1.group)
    else:  # K2 and K3: one kernel template, one plan
        k2 = _k2_plan(b, h, w, c, h_out, w_out, radius, dilation, x.dtype, m.name)
        plan = (k2.rows, k2.step, k2.cols, k2.chunk, k2.group, k2.stride)
        partial = (torch.empty((b, k2.n_strips * k2.n_cols, n), dtype=torch.float32,
                               device=x.device) if fuse_gap else None)
        ptrs.append(None if partial is None else partial.data_ptr())
        ptrs.append(_arrival_counters(x.device, b).data_ptr() if fuse_gap else None)
    vec_width = 4 if x.dtype == torch.float32 else 8  # elements per 16 bytes
    vec = int(c % vec_width == 0 and x.data_ptr() % 16 == 0)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _library_fn(name)(
            *ptrs, int(x.dtype == torch.bfloat16),
            b, h, w, c, h_out, w_out, radius, dilation, padding,
            PAD_MODES.index(padding_mode), _MEASURE_IDS[m.name],
            _FINALIZE_IDS[m.finalize_kind], int(similarity), int(fuse_gap),
            vec, p, eps, q_scs, *plan, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {rc}")
    return out.to(x.dtype)


def _attention(wrapper, x, radius, m, *, similarity, fuse_gap, **kw):
    """``attention``: the ``dot`` kernel, a softmax over the neighbours,
    then the pooling, as ``nfp_pallas`` does (softmax-of-mean is not
    mean-of-softmax, so the map is never fused)."""
    raw = wrapper(x, radius, "dot", similarity=True, fuse_gap=False, **kw)
    out = m.finalize(torch.softmax(raw, dim=-1), similarity)
    return torch.mean(out, dim=(1, 2)) if fuse_gap else out


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
    """Small-map NFP(+GAP) on an NHWC map, stride 1 (K1, ``csrc/nfp_small.cu``).

    Returns ``(B, N)`` with ``fuse_gap``, else ``(B, H', W', N)``, in the
    input dtype. A CUDA input must be a contiguous fp32/bf16 NHWC tensor
    whose output map has at most 256 positions; anything else raises.
    ``attention`` runs the ``dot`` kernel, then a softmax over the
    neighbours, then the pooling, as ``nfp_pallas`` does.
    ``nfp_small_cuda.launches`` counts kernel launches.
    """
    kw = dict(p=p, eps=eps, q_scs=q_scs, padding=padding, dilation=dilation,
              padding_mode=padding_mode)
    if x.device.type == "cpu":
        return nfp_reference(x, radius, measure, similarity=similarity,
                             fuse_gap=fuse_gap, **kw)
    m = get_measure(measure)
    if m.needs_softmax_over_neighbors:
        return _attention(nfp_small_cuda, x, radius, m, similarity=similarity,
                          fuse_gap=fuse_gap, **kw)
    if m.name not in _MEASURE_IDS:
        raise ValueError(f"the NFP kernel does not take measure {m.name!r}")
    out = _launch("nfp_small", x, radius, m, similarity=similarity,
                  fuse_gap=fuse_gap, max_positions=_MAX_POSITIONS, **kw)
    nfp_small_cuda.launches += 1
    return out


nfp_small_cuda.launches = 0


def nfp_large_cuda(
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
    """Large-map NFP(+GAP) on an NHWC map, stride 1, for the separable
    measures (K2, ``csrc/nfp_large.cu``).

    Returns ``(B, N)`` with ``fuse_gap``, else ``(B, H', W', N)``, in the
    input dtype. A CUDA input must be a contiguous fp32/bf16 NHWC tensor;
    any map size and channel count is taken (the C <= 48/64 caps are the
    dispatch policy of ``nfp``, not limits of the kernel). A measure
    without a separable form (``pearson``, ``mahalanobis``) raises.
    ``attention`` runs the ``dot`` kernel, then a softmax over the
    neighbours, then the pooling. ``nfp_large_cuda.launches`` counts
    kernel launches (the fused GAP is reduced within the launch). The cut of
    the work is ``_k2_plan``'s.
    """
    kw = dict(p=p, eps=eps, q_scs=q_scs, padding=padding, dilation=dilation,
              padding_mode=padding_mode)
    if x.device.type == "cpu":
        return nfp_reference(x, radius, measure, similarity=similarity,
                             fuse_gap=fuse_gap, **kw)
    m = get_measure(measure)
    if m.needs_softmax_over_neighbors:
        return _attention(nfp_large_cuda, x, radius, m, similarity=similarity,
                          fuse_gap=fuse_gap, **kw)
    if get_separable(m.name) is None:
        raise ValueError(f"nfp_large_cuda takes the separable measures, not {m.name!r}")
    out = _launch("nfp_large", x, radius, m, similarity=similarity,
                  fuse_gap=fuse_gap, **kw)
    nfp_large_cuda.launches += 1
    return out


nfp_large_cuda.launches = 0


def nfp_strip_cuda(
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
    """Large-map NFP(+GAP) on an NHWC map, stride 1, for every stat-free
    measure (K3, ``csrc/nfp_strip.cu``).

    Returns ``(B, N)`` with ``fuse_gap``, else ``(B, H', W', N)``, in the
    input dtype. A CUDA input must be a contiguous fp32/bf16 NHWC tensor;
    any map size and channel count is taken. ``mahalanobis`` raises on
    either device, as the TPU body does: it needs per-sample statistics,
    which only the plain version computes. ``attention`` runs the ``dot``
    kernel, then a softmax over the neighbours, then the pooling.
    ``nfp_strip_cuda.launches`` counts kernel launches (the fused GAP is
    reduced within the launch). The cut of the work is ``_k2_plan``'s for
    the measure: K3 runs K2's kernel template, with ``pearson`` added.
    """
    kw = dict(p=p, eps=eps, q_scs=q_scs, padding=padding, dilation=dilation,
              padding_mode=padding_mode)
    m = get_measure(measure)
    if m.name not in _MEASURE_IDS and not m.needs_softmax_over_neighbors:
        raise ValueError(f"the NFP kernels take the stat-free measures, not {m.name!r}")
    if x.device.type == "cpu":
        return nfp_reference(x, radius, measure, similarity=similarity,
                             fuse_gap=fuse_gap, **kw)
    if m.needs_softmax_over_neighbors:
        return _attention(nfp_strip_cuda, x, radius, m, similarity=similarity,
                          fuse_gap=fuse_gap, **kw)
    out = _launch("nfp_strip", x, radius, m, similarity=similarity,
                  fuse_gap=fuse_gap, **kw)
    nfp_strip_cuda.launches += 1
    return out


nfp_strip_cuda.launches = 0


def _route(shape, radius, measure, stride, padding, dilation, data_format,
           fuse_gap) -> str:
    """Where the JAX ``nfp`` sends a configuration (``_forward_value``):
    ``"kernel"`` (the small-map kernel K1), ``"k2"`` (the large-map kernel)
    or ``"reference"`` (the plain version)."""
    h_axis, w_axis, c_axis = (2, 3, 1) if data_format == "NCHW" else (1, 2, 3)
    h_out = nfp_output_size(shape[h_axis], radius, stride, padding, dilation)
    w_out = nfp_output_size(shape[w_axis], radius, stride, padding, dilation)
    small_map = h_out * w_out <= _MAX_POSITIONS
    chw_cap = _CHW_GAP_MAX_CHANNELS if fuse_gap else _CHW_MAX_CHANNELS
    chw_eligible = (get_separable(measure) is not None
                    and shape[c_axis] <= chw_cap)
    if not (kernel_supported(measure, stride) and (small_map or chw_eligible)):
        return "reference"
    return "kernel" if small_map else "k2"


class _KernelForward(torch.autograd.Function):
    """``forward(x)`` = ``kernel(x)``, ``backward`` = the vector-Jacobian
    product of ``nfp_reference(x, **ref_kw)``, recomputed on the saved
    input under ``torch.enable_grad()`` (JAX ``_nfp_bwd``,
    nfp_pallas.py:647-661)."""

    @staticmethod
    def forward(ctx, x, kernel, ref_kw):
        ctx.save_for_backward(x)
        ctx.ref_kw = ref_kw
        return kernel(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        with torch.enable_grad():
            xx = x.detach().requires_grad_(True)
            out = nfp_reference(xx, **ctx.ref_kw)
            (dx,) = torch.autograd.grad(out, xx, g)
        return dx, None, None


def _differentiable(x, kernel, ref_kw):
    """``kernel(x)`` (a callable of the input alone, which computes what
    ``nfp_reference(x, **ref_kw)`` does), made differentiable through the
    plain version when ``x`` needs a gradient; a plain call otherwise, so
    inference runs exactly the kernel."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _KernelForward.apply(x, kernel, ref_kw)
    return kernel(x)


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
    module docstring for where each input runs. Differentiable on either
    device: on the CPU and on the ``"reference"`` route autograd
    differentiates the plain version directly; on the card the kernel runs
    forward and the plain version's autograd backward.
    """
    ref_kw = dict(radius=radius, measure=measure, similarity=similarity, p=p,
                  eps=eps, q_scs=q_scs, stride=stride, padding=padding,
                  dilation=dilation, padding_mode=padding_mode,
                  data_format=data_format, fuse_gap=fuse_gap)
    route = _route(tuple(x.shape), radius, measure, stride, padding, dilation,
                   data_format, fuse_gap)
    if x.device.type != "cuda" or route == "reference":
        return nfp_reference(x, **ref_kw)
    wrapper = nfp_large_cuda if route == "k2" else nfp_small_cuda

    def kernel(xx):
        xh = xx.permute(0, 2, 3, 1) if data_format == "NCHW" else xx
        out = wrapper(
            xh.contiguous(), radius, measure, similarity=similarity, p=p, eps=eps,
            q_scs=q_scs, padding=padding, dilation=dilation,
            padding_mode=padding_mode, fuse_gap=fuse_gap)
        if not fuse_gap and data_format == "NCHW":
            out = out.permute(0, 3, 1, 2)
        return out

    return _differentiable(x, kernel, ref_kw)


def _kernel_route(shape, radius, measure, padding, dilation, chw_body="auto") -> str:
    """Which body the JAX ``nfp_pallas`` runs a configuration through
    (nfp_pallas.py:263-362): ``"k1"`` for maps of at most 256 output
    positions, ``"k2"`` for larger maps with a separable measure, ``"k3"``
    for the rest. ``attention`` takes the route of ``dot``. Raises
    ``ValueError`` where ``nfp_pallas`` does: ``mahalanobis``, an empty
    output map, and an unknown ``chw_body`` on the K2 branch only."""
    m = get_measure(measure)
    if m.needs_softmax_over_neighbors:
        m = get_measure("dot")
    if m.name not in _MEASURE_IDS:
        raise ValueError(f"the NFP kernels take the stat-free measures, not {m.name!r}")
    _, h, w, _ = shape
    h_out = nfp_output_size(h, radius, 1, padding, dilation)
    w_out = nfp_output_size(w, radius, 1, padding, dilation)
    if h_out < 1 or w_out < 1:
        raise ValueError(
            f"NFP output size {h_out}x{w_out} invalid for input {h}x{w}, "
            f"R={radius}, padding={padding}, dilation={dilation}")
    if h_out * w_out <= _MAX_POSITIONS:
        return "k1"
    if get_separable(m.name) is not None:
        if chw_body not in ("auto", "fori", "vec"):
            raise ValueError(f"unknown chw_body {chw_body!r}")
        return "k2"
    return "k3"


_ROUTE_WRAPPERS = {"k1": nfp_small_cuda, "k2": nfp_large_cuda, "k3": nfp_strip_cuda}


def nfp_kernel(
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
    chw_body: str = "auto",
) -> torch.Tensor:
    """The NFP(+GAP) kernel on an NHWC map, stride 1: the counterpart of
    the JAX ``nfp_pallas`` (same arguments, without the TPU's
    ``interpret``).

    Routes as ``nfp_pallas`` picks its body (``_kernel_route``): K1 for
    maps of at most 256 output positions, K2 for larger maps with a
    separable measure at any channel count, K3 for the rest (``pearson``).
    ``attention`` runs the ``dot`` kernel of its route, then a softmax over
    the neighbours outside it; ``mahalanobis`` raises ``ValueError``.
    ``chw_body`` takes the JAX values ``"auto"``, ``"fori"`` and ``"vec"``
    and is checked where ``nfp_pallas`` checks it, on the K2 branch only.
    On the card all three run K2: the split between a per-channel loop and
    whole-C slices is a choice of the TPU's lane layout, which K2 does not
    have. On a CPU tensor the plain version runs.
    """
    route = _kernel_route(tuple(x.shape), radius, measure, padding, dilation, chw_body)
    kw = dict(similarity=similarity, p=p, eps=eps, q_scs=q_scs, padding=padding,
              dilation=dilation, padding_mode=padding_mode, fuse_gap=fuse_gap)
    if x.device.type != "cuda":
        return nfp_reference(x, radius, measure, **kw)
    return _ROUTE_WRAPPERS[route](x.contiguous(), radius, measure, **kw)
