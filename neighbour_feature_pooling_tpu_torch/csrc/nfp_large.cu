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
// op reads 25.7 MB once (7.7 us at 3.35 TB/s) and does ~6 flops per channel
// per (position, neighbour) pair, 308 MFLOP (4.6 us at 67 TFLOP/s): bytes.
// Each pixel is read by nine threads (its own and its eight neighbours'),
// from L1/L2 after the first.
//
// Design:
//  * The TPU body puts W on the vector lanes and transposes the padded map
//    to channels-first to do it. Here one thread owns one output position:
//    it walks the k*k-1 neighbours and, for each, the channels, summing the
//    measure's per-channel terms in fp32 registers (up to three sums), then
//    applies the tail and the sign finalize. No cross-thread reduction over
//    channels exists, which suits the narrow channels of these maps.
//  * The input is the unpadded NHWC map the backbone produced (channels_last
//    memory). Padding is applied in the loads by the jnp.pad index rule
//    (nfp_measures.cuh::src_index), so neither a padded copy nor a
//    channels-first transpose is ever written.
//  * Channels are read with 16-byte loads when C is a multiple of 4 (fp32) /
//    8 (bf16) and the base pointer is 16-byte aligned, else one at a time.
//  * Grid: (position tiles of kTile, B). At the first tap that is 49 x 32
//    blocks of 256 threads, so every SM has work at any batch.
//  * Fused GAP, bit-repeatable: each value is finalized first (as K1 and the
//    plain version do; the TPU body finalizes the mean instead, which agrees
//    up to rounding), summed over the block in a fixed order (warp shuffle
//    tree, then the warps in order) and written as one partial per
//    (image, tile, neighbour); gap_reduce (nfp_measures.cuh, shared with
//    K3) sums the partials of an image in tile order and divides by the
//    position count. No atomics.
//  * Output is fp32: (B, N) with fuse_gap, else (B, H', W', N); the Python
//    wrapper casts it to the input dtype.
//
// C interface (bound with ctypes): nfp_large_forward returns the
// cudaError_t of its launches; it never synchronises and allocates
// nothing (the wrapper passes the partial-sum buffer).

#include "nfp_measures.cuh"

namespace {

using namespace nfp;

constexpr int kTile = 256;  // output positions (threads) per block

template <typename T>
__global__ void __launch_bounds__(kTile)
nfp_large_kernel(const T* __restrict__ x, float* __restrict__ out,
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
  const int pos = blockIdx.x * kTile + threadIdx.x;
  const bool live = pos < n_pos;
  const int oh = live ? pos / a.Wo : 0;
  const int ow = live ? pos % a.Wo : 0;
  const T* img = x + b * a.H * a.W * a.C;

  const int ch = src_index(oh + r - a.padding, a.H, a.pad_mode);
  const int cw = src_index(ow + r - a.padding, a.W, a.pad_mode);
  const T* pc = (ch < 0 || cw < 0)
      ? nullptr : img + ((long long)ch * a.W + cw) * a.C;

  for (int nb = 0; nb < n_nb; ++nb) {
    const int t = nb < centre ? nb : nb + 1;
    const int i = t / k, j = t % k;
    float v = 0.f;
    if (live) {
      const int nh = src_index(oh + i * a.dilation - a.padding, a.H, a.pad_mode);
      const int nw = src_index(ow + j * a.dilation - a.padding, a.W, a.pad_mode);
      const T* pn = (nh < 0 || nw < 0)
          ? nullptr : img + ((long long)nh * a.W + nw) * a.C;
      float s0 = 0.f, s1 = 0.f, s2 = 0.f;
      for_channels(pc, pn, a, 0, 1,
                   [&](float c, float n) { add_terms(a, c, n, s0, s1, s2); });
      v = apply_finalize(a, finish(a, s0, s1, s2));
      if (!a.fuse_gap) out[(b * n_pos + pos) * n_nb + nb] = v;  // (B,H',W',N)
    }
    if (a.fuse_gap) {
      v = warp_sum(v);  // dead positions add 0
      if (lane == 0) warp_sums[warp * n_nb + nb] = v;
    }
  }
  if (a.fuse_gap) {
    __syncthreads();
    const int n_warps = blockDim.x >> 5;
    for (int nb = threadIdx.x; nb < n_nb; nb += blockDim.x) {
      float s = 0.f;
      for (int w = 0; w < n_warps; ++w) s += warp_sums[w * n_nb + nb];
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
  const size_t smem = a.fuse_gap ? (size_t)(kTile / 32) * n_nb * sizeof(float) : 0;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        nfp_large_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  nfp_large_kernel<T><<<dim3(n_tiles, batch), kTile, smem, stream>>>(
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
extern "C" int nfp_large_tile_positions() { return kTile; }

extern "C" int nfp_large_forward(
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
