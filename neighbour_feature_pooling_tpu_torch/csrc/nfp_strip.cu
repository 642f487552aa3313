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
// reads 25.7 MB once (7.7 us at 3.35 TB/s) and does ~10 flops per channel
// per (position, neighbour) pair, 514 MFLOP (7.7 us at 67 TFLOP/s). This
// first version is bound by neither: a warp per position with lanes over
// 16 channels keeps most lanes idle and spends its time in the shuffle
// reductions (five warp sums per pair for pearson). Speed is later work.
//
// Design:
//  * The TPU body walks H in strips only to fit its scoped VMEM; nothing of
//    that is carried over. One warp owns one output position of one image:
//    it walks the k*k-1 neighbours and, for each, calls pair_value
//    (nfp_measures.cuh, shared with K1): lanes over C with 16-byte loads
//    when C is a multiple of 4 (fp32) / 8 (bf16) and the base pointer is
//    16-byte aligned, else scalar loads, fp32 sums, __shfl_xor_sync
//    reductions, pearson's two passes, the tail and the sign finalize.
//  * Grid: (position tiles of kTile, B); the kWarps warps of a block take
//    the tile's positions in turn. Padding is applied in the loads by the
//    jnp.pad index rule (src_index), so no padded copy is written; offsets
//    are 64-bit.
//  * Fused GAP, bit-repeatable as in K2: lane 0 of each warp adds its
//    positions' values to its own row of shared memory in position order,
//    the block sums the rows in warp order into one partial per (image,
//    tile, neighbour), and gap_reduce adds an image's partials in a fixed
//    order (nfp_measures.cuh). No atomics. Each value is finalized before the sum (the TPU body
//    finalizes the mean instead, which agrees up to rounding).
//  * Output is fp32: (B, N) with fuse_gap, else (B, H', W', N); the Python
//    wrapper casts it to the input dtype.
//
// C interface (bound with ctypes): nfp_strip_forward returns the
// cudaError_t of its launches; it never synchronises and allocates
// nothing (the wrapper passes the partial-sum buffer).

#include "nfp_measures.cuh"

namespace {

using namespace nfp;

constexpr int kWarps = 8;   // warps per block
constexpr int kTile = 64;   // output positions per block

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
nfp_strip_kernel(const T* __restrict__ x, float* __restrict__ out,
                 float* __restrict__ partial, Args a) {
  extern __shared__ float warp_sums[];  // fuse_gap: [warp][neighbour]
  const int k = 2 * a.radius + 1;
  const int n_nb = k * k - 1;
  const int centre = (k * k) / 2;  // row-major index of the centre tap
  const int n_pos = a.Ho * a.Wo;
  const int r = a.radius * a.dilation;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long b = blockIdx.y;
  const T* img = x + b * a.H * a.W * a.C;

  if (a.fuse_gap) {
    for (int i = threadIdx.x; i < kWarps * n_nb; i += blockDim.x) warp_sums[i] = 0.f;
    __syncthreads();
  }
  const int first = blockIdx.x * kTile;
  const int last = min(first + kTile, n_pos);
  for (int pos = first + warp; pos < last; pos += kWarps) {  // warp-uniform
    const int oh = pos / a.Wo, ow = pos % a.Wo;
    const int ch = src_index(oh + r - a.padding, a.H, a.pad_mode);
    const int cw = src_index(ow + r - a.padding, a.W, a.pad_mode);
    const T* pc = (ch < 0 || cw < 0)
        ? nullptr : img + ((long long)ch * a.W + cw) * a.C;
    for (int nb = 0; nb < n_nb; ++nb) {
      const int t = nb < centre ? nb : nb + 1;
      const int i = t / k, j = t % k;
      const int nh = src_index(oh + i * a.dilation - a.padding, a.H, a.pad_mode);
      const int nw = src_index(ow + j * a.dilation - a.padding, a.W, a.pad_mode);
      const T* pn = (nh < 0 || nw < 0)
          ? nullptr : img + ((long long)nh * a.W + nw) * a.C;
      const float v = pair_value(pc, pn, a, lane);
      if (lane == 0) {
        if (a.fuse_gap) warp_sums[warp * n_nb + nb] += v;
        else out[(b * n_pos + pos) * n_nb + nb] = v;  // (B, H', W', N)
      }
    }
  }
  if (a.fuse_gap) {
    __syncthreads();
    for (int nb = threadIdx.x; nb < n_nb; nb += blockDim.x) {
      float s = 0.f;
      for (int w = 0; w < kWarps; ++w) s += warp_sums[w * n_nb + nb];
      partial[(b * gridDim.x + blockIdx.x) * n_nb + nb] = s;
    }
  }
}

template <typename T>
int launch(const void* x, void* out, void* partial, int batch, const Args& a,
           cudaStream_t stream) {
  const int k = 2 * a.radius + 1;
  const int n_nb = k * k - 1;
  const int n_tiles = (a.Ho * a.Wo + kTile - 1) / kTile;
  const size_t smem = a.fuse_gap ? (size_t)kWarps * n_nb * sizeof(float) : 0;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        nfp_strip_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  nfp_strip_kernel<T><<<dim3(n_tiles, batch), kWarps * 32, smem, stream>>>(
      static_cast<const T*>(x), static_cast<float*>(out),
      static_cast<float*>(partial), a);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || !a.fuse_gap) return (int)e;
  return launch_gap_reduce(partial, out, batch, n_tiles, n_nb, a.Ho * a.Wo,
                           stream);
}

}  // namespace

// Output positions per block: the wrapper sizes the partial-sum buffer
// (B, ceil(H'W' / tile), N) with it.
extern "C" int nfp_strip_tile_positions() { return kTile; }

extern "C" int nfp_strip_forward(
    const void* x, void* out, void* partial, int is_bf16, int batch, int H,
    int W, int C, int Ho, int Wo, int radius, int dilation, int padding,
    int pad_mode, int measure, int finalize, int similarity, int fuse_gap,
    int vec, float p, float eps, float q_scs, void* stream) {
  const Args a{H, W, C, Ho, Wo, radius, dilation, padding, pad_mode,
               measure, finalize, similarity, fuse_gap, vec, p, eps, q_scs};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return launch<__nv_bfloat16>(x, out, partial, batch, a, s);
  return launch<float>(x, out, partial, batch, a, s);
}
