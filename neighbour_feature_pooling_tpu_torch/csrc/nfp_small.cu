// Small-map Neighborhood Feature Pooling (NFP) forward for Hopper (sm_90a).
//
// Replaces the TPU kernel neighbour_feature_pooling_tpu/ops/nfp_pallas.py::
// _nfp_kernel_unrolled: whole-image NFP for maps of at most 256 output
// positions (the texture heads: 7x7 ResNet, 14x14 ViT), stride 1, every
// stat-free measure, optionally fused with the global average pool.
//
// What bounds it: at the serving shape (B=32, 7x7x512 fp32, R=1) the op
// reads 3.2 MB once and does ~6 flops per channel per (position, neighbour)
// pair, 38.5 MFLOP in all: memory-bound on paper (~1 us at 3.35 TB/s). This
// first version is bound instead by latency: one block per image, whose 32
// warps walk the 392 (position, neighbour) pairs one after another (~50 us
// on an H100, PERF.md).
//
// Design:
//  * One block per image, so the fused GAP is a fixed-order sum in shared
//    memory: no atomics, results repeat bit for bit. B blocks fill B SMs
//    (32 of 132 at the serving batch); tiling positions across blocks is
//    later work.
//  * One warp per (position, neighbour) pair. Lanes stride over C with
//    16-byte loads when C is a multiple of 4 (fp32) / 8 (bf16) and the base
//    pointer is 16-byte aligned, else with scalar loads. Each lane sums the
//    measure's channel terms in fp32; __shfl_xor_sync reduces them; the
//    pairwise tail and the sign finalize follow. pearson takes two passes
//    (channel means first), as the centred form in measures.py does.
//  * Padding is applied in-kernel through the same index rule as
//    ops/neighborhood.py::pad_index (jnp.pad semantics), so the padded copy
//    of the map is never written. The input is the unpadded NHWC map.
//  * Output is fp32: (B, N) with fuse_gap, else (B, H', W', N); the Python
//    wrapper casts it to the input dtype.
//  * The measure terms, tails, loads, padding rule and the warp's pair
//    value (pair_value) are shared with the large-map kernels nfp_large.cu
//    and nfp_strip.cu, in nfp_measures.cuh.
//
// C interface (bound with ctypes): nfp_small_forward returns the
// cudaError_t of the launch; it never synchronises and allocates nothing.

#include "nfp_measures.cuh"

namespace {

using namespace nfp;

constexpr int kThreads = 1024;

template <typename T>
__global__ void __launch_bounds__(kThreads)
nfp_small_kernel(const T* __restrict__ x, float* __restrict__ out, Args a) {
  extern __shared__ float vals[];  // fuse_gap: one value per pair
  const int k = 2 * a.radius + 1;
  const int n_nb = k * k - 1;
  const int centre = (k * k) / 2;  // row-major index of the centre tap
  const int n_pos = a.Ho * a.Wo;
  const int r = a.radius * a.dilation;
  const int lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  const long long b = blockIdx.x;
  const T* img = x + b * a.H * a.W * a.C;

  for (int q = threadIdx.x >> 5; q < n_pos * n_nb; q += n_warps) {
    const int pos = q / n_nb, nb = q % n_nb;
    const int oh = pos / a.Wo, ow = pos % a.Wo;
    const int t = nb < centre ? nb : nb + 1;
    const int i = t / k, j = t % k;
    const int ch = src_index(oh + r - a.padding, a.H, a.pad_mode);
    const int cw = src_index(ow + r - a.padding, a.W, a.pad_mode);
    const int nh = src_index(oh + i * a.dilation - a.padding, a.H, a.pad_mode);
    const int nw = src_index(ow + j * a.dilation - a.padding, a.W, a.pad_mode);
    const T* pc = (ch < 0 || cw < 0)
        ? nullptr : img + ((long long)ch * a.W + cw) * a.C;
    const T* pn = (nh < 0 || nw < 0)
        ? nullptr : img + ((long long)nh * a.W + nw) * a.C;
    const float v = pair_value(pc, pn, a, lane);
    if (lane == 0) {
      if (a.fuse_gap) vals[q] = v;
      else out[b * n_pos * n_nb + q] = v;  // (B, H', W', N)
    }
  }
  if (a.fuse_gap) {
    __syncthreads();
    for (int nb = threadIdx.x; nb < n_nb; nb += blockDim.x) {
      float s = 0.f;
      for (int pos = 0; pos < n_pos; ++pos) s += vals[pos * n_nb + nb];
      out[b * n_nb + nb] = s / (float)n_pos;
    }
  }
}

template <typename T>
int launch(const void* x, void* out, int batch, const Args& a,
           cudaStream_t stream) {
  const int k = 2 * a.radius + 1;
  const size_t smem =
      a.fuse_gap ? (size_t)a.Ho * a.Wo * (k * k - 1) * sizeof(float) : 0;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        nfp_small_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  nfp_small_kernel<T><<<batch, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<float*>(out), a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int nfp_small_forward(
    const void* x, void* out, int is_bf16, int batch, int H, int W, int C,
    int Ho, int Wo, int radius, int dilation, int padding, int pad_mode,
    int measure, int finalize, int similarity, int fuse_gap, int vec,
    float p, float eps, float q_scs, void* stream) {
  const Args a{H, W, C, Ho, Wo, radius, dilation, padding, pad_mode,
               measure, finalize, similarity, fuse_gap, vec, p, eps, q_scs};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return launch<__nv_bfloat16>(x, out, batch, a, s);
  return launch<float>(x, out, batch, a, s);
}
