// Large-map Neighborhood Feature Pooling (NFP) forward for Hopper (sm_90a),
// for every stat-free measure.
//
// Replaces the TPU kernel neighbour_feature_pooling_tpu/ops/nfp_pallas.py::
// _nfp_kernel: the NHWC body for maps of more than 256 output positions.
// The TPU entry nfp_pallas sends it the measures without a channel-sum
// form (pearson: channel means first, then the centred sums), but the body
// is generic over the measure, and so is this one. Stride 1, any radius,
// dilation, padding, padding mode and channel count, optionally fused with
// the global average pool.
//
// What bounds it: at (B=32, 112x112x16 fp32, R=1, pearson, fused) the op
// reads 25.7 MB once (7.7 us at 3.35 TB/s). Once each pixel's mean and
// centred sum of squares are shared, a pair does one subtraction and one
// fma per channel, ~3 flops, 154 MFLOP there (2.3 us at 67 TFLOP/s):
// bytes, on paper. What holds the design on the H100 is what holds K2:
// instruction issue and the phases a block runs in turn (PERF.md §6).
//
// Design: the strip kernel of nfp_strips.cuh, as K2 (nfp_large.cu) runs
// it, instantiated for pearson and the 15 separable measures, fp32 and
// bf16. Pearson adds a per-pixel pass (each staged pixel's channel mean,
// then its centred sum of squares, both kept in shared memory), centres
// the centre pixel once in registers and each neighbour as it is read, and
// with a chunked C takes a first pass over the chunks for the means.
//
// C interface (bound with ctypes): nfp_strip_forward returns the
// cudaError_t of its launch; it never synchronises and allocates nothing
// (the wrapper passes the partial-sum buffer, one row per strip, and the
// zeroed arrival counters, one per image).

#include "nfp_strips.cuh"

extern "C" int nfp_strip_forward(
    const void* x, void* out, void* partial, void* arrived, int is_bf16, int batch, int H,
    int W, int C, int Ho, int Wo, int radius, int dilation, int padding,
    int pad_mode, int measure, int finalize, int similarity, int fuse_gap,
    int vec, float p, float eps, float q_scs, int rows, int step, int cols,
    int chunk, int group, int stride, void* stream) {
  const Args a{H, W, C, Ho, Wo, radius, dilation, padding, pad_mode,
               measure, finalize, similarity, fuse_gap, vec, p, eps, q_scs};
  const Plan pl{rows, step, cols, chunk, group, stride};
  return strips_forward<true>(x, out, partial, arrived, is_bf16, batch, a, pl, stream);
}
