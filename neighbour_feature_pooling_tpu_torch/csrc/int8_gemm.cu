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
// output, and with one to four K steps the kernel is almost only its
// epilogue: what holds it back is the launch and the pass of the results
// through shared memory to reach 16-byte row-wide stores.
//
// Design: the TPU kernel's sequential K grid axis with a VMEM accumulator
// becomes a loop over K inside each block, with the accumulators in
// registers (int8_mma.cuh, shared with K5). B arrives packed (N, Kp) with k
// contiguous. The gather below reads the row-major A: 16-byte chunks when
// K % 16 == 0, 4-byte words when K % 4 == 0, else bytes; ragged M, N and K
// are masked in the kernel, so A is never padded on the host. Two tile
// sizes, chosen by the wrapper.
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
  };

  __device__ Row row(int m) const {
    Row r;
    r.base = (long long)m * K;
    r.iy0 = m < M ? 0 : -1;  // -1: a row past M reads zeros
    r.ix0 = 0;
    return r;
  }

  __device__ Tap tap(int k) const { return Tap{k}; }

  __device__ void advance(Tap& t) const { t.k += BK; }

  __device__ bool at(const Row& r, const Tap& t, long long& off) const {
    off = r.base + t.k;
    return t.k < K && r.iy0 == 0;
  }
};

template <int BM, int AMODE>
__global__ void __launch_bounds__(Tile<BM>::kThreads, Tile<BM>::kMinBlocks)
int8_gemm_kernel(GemmGather g, const int8_t* __restrict__ a,
                 const int8_t* __restrict__ bp, int N, int Kp, Epilogue e,
                 void* out) {
  extern __shared__ __align__(1024) unsigned char smem[];
  mma_tile<GemmGather, BM, AMODE>(g, a, bp, g.M, N, g.K, Kp, e, out, smem);
}

template <int BM, int AMODE>
int launch_mode(const GemmGather& g, const int8_t* a, const int8_t* bp, int N,
                int Kp, const Epilogue& e, void* out, cudaStream_t s) {
  static bool ready[kMaxDevices] = {};  // of this instantiation
  return launch_tile<BM>(int8_gemm_kernel<BM, AMODE>, ready, g.M, N, s, g, a, bp, N,
                         Kp, e, out);
}

template <int BM>
int launch(int a_mode, const GemmGather& g, const int8_t* a, const int8_t* bp,
           int N, int Kp, const Epilogue& e, void* out, cudaStream_t s) {
  switch (a_mode) {
    case A_CHUNKS: return launch_mode<BM, A_CHUNKS>(g, a, bp, N, Kp, e, out, s);
    case A_WORDS: return launch_mode<BM, A_WORDS>(g, a, bp, N, Kp, e, out, s);
    default: return launch_mode<BM, A_BYTES>(g, a, bp, N, Kp, e, out, s);
  }
}

}  // namespace

// bp: B packed (N, Kp), Kp = K rounded up to 16. a_mode: AMode; small_tile:
// 64 x 64 tiles instead of 128 x 64.
extern "C" int int8_gemm_forward(const void* a, const void* bp,
                                 const float* scale, const float* bias,
                                 void* out, int M, int N, int K, int out_kind,
                                 int relu, int a_mode, int small_tile,
                                 void* stream) {
  const GemmGather g{K, M};
  const Epilogue e{scale, bias, out_kind, relu};
  const int Kp = (K + 15) / 16 * 16;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* ap = static_cast<const int8_t*>(a);
  const int8_t* bpp = static_cast<const int8_t*>(bp);
  return small_tile ? launch<64>(a_mode, g, ap, bpp, N, Kp, e, out, s)
                    : launch<128>(a_mode, g, ap, bpp, N, Kp, e, out, s);
}
