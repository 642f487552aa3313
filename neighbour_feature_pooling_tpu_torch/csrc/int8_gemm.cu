// int8 GEMM for Hopper (sm_90a): (M, K) s8 x (K, N) s8 -> (M, N) s32, or
// the fused dequant epilogue in fp32 or requantized s8 (K4).
//
// Replaces the TPU kernel neighbour_feature_pooling_tpu/ops/int8_gemm.py::
// _gemm_kernel / _gemm_kernel_fused (pallas_call at :109): a K-accumulating
// GEMM whose flush applies ops/common.py::dequant_epilogue, so the s32
// accumulator never reaches device memory in the fused form.
//
// What bounds it: the GEMMs of int8 ResNet18 serving are its three 1x1
// downsample convs, (25088, 64) x (64, 128) at B=32 the largest: 0.4 G
// int8 operations (0.2 us at 1,979 TOPS) against 1.6 MB in and 12.8 MB of
// fp32 out (4.3 us at 3.35 TB/s). They are bound by the bytes of their
// output, and this first version, which runs mma.sync from shared-memory
// tiles staged by ordinary loads, by the latency of its K loop.
//
// Design: the TPU kernel's sequential K grid axis with a VMEM accumulator
// becomes a loop over K inside each block, with the accumulators in
// registers (int8_mma.cuh, shared with K5). The gather below reads the
// row-major A; ragged M, N and K are masked in the kernel, so nothing is
// padded on the host. Tile sizes are the kernel's own choice.
//
// C interface (bound with ctypes): int8_gemm_forward returns the
// cudaError_t of the launch; it never synchronises and allocates nothing.

#include "int8_mma.cuh"

namespace {

using namespace int8k;

struct GemmGather {
  int K, M;

  struct Tap {
    int k;
    bool ok;
  };

  __device__ Row row(int m) const {
    Row r;
    r.base = (long long)m * K;
    r.iy0 = m < M ? 0 : -1;  // -1: a row past M reads zeros
    r.ix0 = 0;
    return r;
  }

  __device__ Tap tap(int k) const { return Tap{k, k < K}; }

  __device__ bool at(const Row& r, const Tap& t, long long& off) const {
    off = r.base + t.k;
    return t.ok && r.iy0 == 0;
  }
};

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
int8_gemm_kernel(GemmGather g, const int8_t* __restrict__ a,
                 const int8_t* __restrict__ b, int N, int vec_b, Epilogue e,
                 void* out) {
  __shared__ __align__(16) Smem sm;
  mma_tile<GemmGather, VEC>(g, a, b, g.M, N, g.K, vec_b != 0, e, out, sm);
}

}  // namespace

extern "C" int int8_gemm_forward(const void* a, const void* b,
                                 const float* scale, const float* bias,
                                 void* out, int M, int N, int K, int out_kind,
                                 int relu, int vec, void* stream) {
  const GemmGather g{K, M};
  const Epilogue e{scale, bias, out_kind, relu};
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* ap = static_cast<const int8_t*>(a);
  const int8_t* bp = static_cast<const int8_t*>(b);
  const int vec_b = N % 4 == 0 && reinterpret_cast<uintptr_t>(b) % 4 == 0;
  if (vec)
    int8_gemm_kernel<true><<<grid, kThreads, 0, s>>>(g, ap, bp, N, vec_b, e, out);
  else
    int8_gemm_kernel<false><<<grid, kThreads, 0, s>>>(g, ap, bp, N, vec_b, e, out);
  return (int)cudaGetLastError();
}
