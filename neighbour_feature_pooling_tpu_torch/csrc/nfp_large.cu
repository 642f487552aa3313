// Large-map Neighborhood Feature Pooling (NFP) forward for Hopper (sm_90a).
//
// Replaces the TPU kernel neighbour_feature_pooling_tpu/ops/nfp_pallas.py::
// _nfp_kernel_chw: NFP on maps of more than 256 output positions (the
// MobileNetV3 stage taps 112x112x16, 56x56x24, 28x28x40, the in-backbone
// nfp_insert map) for the separable measures (ops/measures.py::SEPARABLE:
// channel sums, then a scalar tail), stride 1, any radius, dilation,
// padding mode and channel count, optionally fused with the global average
// pool.
//
// What bounds it: at the first tap (B=32, 112x112x16 fp32, R=1, fused) the
// op reads 25.7 MB once (7.7 us at 3.35 TB/s) and, once each pixel's norm
// is shared, does ~2 flops per channel per (position, neighbour) pair, 103
// MFLOP: bytes, on paper. This design reads nine staged pixels per position
// from shared memory (~230 MB at that tap, ~8 us of the SMs' shared-memory
// bandwidth), and what holds it on the H100 is instruction issue and
// latency: ~600 instructions per position for 128 useful FMAs (addresses,
// predicates, the tails' divisions), and phases (load, pixel sums, pairs,
// GAP) that a block runs one after another with barriers between them.
// Measured: 39.5 us there, 2.1x the old thread-per-position kernel and 5x
// its byte bound (PERF.md §6).
//
// Design: the strip kernel of nfp_strips.cuh (strips of rows in steps, a
// ring of staged rows, a lane group per position with the centre in
// registers, per-pixel tails, the fused GAP reduced in the same launch),
// instantiated here for the 15 separable measures and both dtypes; K3
// (nfp_strip.cu) instantiates the same template for pearson too.
//
// C interface (bound with ctypes): nfp_large_forward returns the
// cudaError_t of its launch; it never synchronises and allocates nothing
// (the wrapper passes the partial-sum buffer, one row per strip, and the
// zeroed arrival counters, one per image).

#include "nfp_strips.cuh"

extern "C" int nfp_large_forward(
    const void* x, void* out, void* partial, void* arrived, int is_bf16, int batch, int H,
    int W, int C, int Ho, int Wo, int radius, int dilation, int padding,
    int pad_mode, int measure, int finalize, int similarity, int fuse_gap,
    int vec, float p, float eps, float q_scs, int rows, int step, int cols,
    int chunk, int group, int stride, void* stream) {
  const Args a{H, W, C, Ho, Wo, radius, dilation, padding, pad_mode,
               measure, finalize, similarity, fuse_gap, vec, p, eps, q_scs};
  const Plan pl{rows, step, cols, chunk, group, stride};
  return strips_forward<false>(x, out, partial, arrived, is_bf16, batch, a, pl, stream);
}
