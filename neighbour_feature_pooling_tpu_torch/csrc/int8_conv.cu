// int8 convolution for Hopper (sm_90a): NHWC s8 (*) HWIO s8 -> NHWC s32,
// or the fused dequant epilogue in fp32 or requantized s8 (K5).
//
// Replaces the TPU kernel neighbour_feature_pooling_tpu/ops/int8_conv.py::
// _conv_kernel / _conv_kernel_fused (pallas_call at :143): a direct conv
// with exact s32 accumulation, any stride and padding, one group, no
// dilation, and the epilogue of ops/common.py::dequant_epilogue.
//
// What bounds it: at the ResNet18 shapes (224 px, B=32) a 3x3 conv does
// 2 x 3.7 G int8 operations on 6.4 MB in and 25.7 MB of fp32 out at the
// first stage, ~4 us of tensor-core time at 1,979 TOPS against ~10 us of
// bytes at 3.35 TB/s: the convs with an fp32 output are bound by bytes on
// paper, the s8-out (chained) ones and the deep stages (K = 2304, 4608 on
// 0.4-1.6 MB of output) by operations. What holds this version back
// (tools/ablate_int8.py): at the deep stages a K step costs ~400 cycles of
// issue and synchronisation latency whatever the tensor cores and the loads
// do, and their grids (200-400 blocks of 36-72 steps) give an SM one to
// three blocks to hide it with: a split over K is the next lever. At the
// first stage the 25.7 MB of output and the blocks' prologue and epilogue
// (9 steps between them) share the time. At the stem each 4-byte cp.async
// costs a bounds check and an address: it is bound by issuing them.
//
// Design: an implicit GEMM (int8_mma.cuh). Row m of the GEMM is the output
// position (b, oy, ox); column k = (dy * kw + dx) * Cin + ci of the HWIO
// weight read as a (kh * kw * Cin, Cout) matrix, which arrives packed
// (Cout, Kp) with k contiguous. The gather below turns (m, k) into the
// input byte x[b, oy * sh - pt + dy, ox * sw - pl + dx, ci], or a zero
// outside the image, so the stride and the padding cost index math only:
// none of the TPU kernel's flattened rows with wrap-around columns, host
// padding or space-to-depth rewrite. With Cin % 16 == 0 a 16-byte chunk of
// k stays inside one tap and is one cp.async; with Cin % 4 == 0 a 4-byte
// word does (the RGB stem arrives padded to four channels, so a word is one
// pixel's tap); any other Cin goes byte by byte. A thread keeps its column's
// tap (dy, dx, ci) and steps it by the precomputed split of 64 bytes.
//
// C interface (bound with ctypes): int8_conv_forward returns the
// cudaError_t of the launch; it never synchronises and allocates nothing.

#include "int8_mma.cuh"

namespace {

using namespace int8k;

struct ConvGather {
  int H, W, Cin, kh, kw, Ho, Wo, sh, sw, pt, pl, M;
  int step_ci, step_dx, step_dy;  // BK columns of k: channels, taps, tap rows
  int row_skip;                   // (W - kw) * Cin

  // Column k of the weight: its tap, and its channel for the next step.
  struct Tap {
    int dy, dx, ci, k;
  };

  __device__ Row row(int m) const {
    Row r;
    if (m >= M) {
      r.base = 0;
      r.iy0 = r.ix0 = -(1 << 29);  // every tap falls outside the image
      return r;
    }
    const int hw = Ho * Wo;
    const int b = m / hw;
    const int rem = m - b * hw;
    const int oy = rem / Wo;
    const int ox = rem - oy * Wo;
    r.iy0 = oy * sh - pt;
    r.ix0 = ox * sw - pl;
    // the byte of tap (0, 0), channel 0, which may lie before the image
    r.base = (((long long)b * H + r.iy0) * W + r.ix0) * Cin;
    return r;
  }

  // Column k; dy >= kh from k = kh * kw * Cin on.
  __device__ Tap tap(int k) const {
    Tap t;
    const int tp = k / Cin;
    t.ci = k - tp * Cin;
    t.dy = tp / kw;
    t.dx = tp - t.dy * kw;
    t.k = k;
    return t;
  }

  // Column k + BK.
  __device__ void advance(Tap& t) const {
    t.ci += step_ci;
    t.dx += step_dx;
    t.dy += step_dy;
    t.k += BK;
    if (t.ci >= Cin) {
      t.ci -= Cin;
      ++t.dx;
    }
    if (t.dx >= kw) {
      t.dx -= kw;
      ++t.dy;
    }
  }

  __device__ bool at(const Row& r, const Tap& t, long long& off) const {
    const int iy = r.iy0 + t.dy, ix = r.ix0 + t.dx;
    // (dy * W + dx) * Cin + ci = k + dy * (W - kw) * Cin
    off = r.base + (t.k + t.dy * row_skip);
    return t.dy < kh && (unsigned)iy < (unsigned)H && (unsigned)ix < (unsigned)W;
  }
};

template <int BM, int AMODE>
__global__ void __launch_bounds__(Tile<BM>::kThreads, Tile<BM>::kMinBlocks)
int8_conv_kernel(ConvGather g, const int8_t* __restrict__ x,
                 const int8_t* __restrict__ wp, int N, int Kp, Epilogue e,
                 void* out) {
  extern __shared__ __align__(1024) unsigned char smem[];
  mma_tile<ConvGather, BM, AMODE>(g, x, wp, g.M, N, g.kh * g.kw * g.Cin, Kp, e,
                                  out, smem);
}

template <int BM, int AMODE>
int launch_mode(const ConvGather& g, const int8_t* x, const int8_t* wp, int N,
                int Kp, const Epilogue& e, void* out, cudaStream_t s) {
  static bool ready[kMaxDevices] = {};  // of this instantiation
  return launch_tile<BM>(int8_conv_kernel<BM, AMODE>, ready, g.M, N, s, g, x, wp, N,
                         Kp, e, out);
}

template <int BM>
int launch(int a_mode, const ConvGather& g, const int8_t* x, const int8_t* wp,
           int N, int Kp, const Epilogue& e, void* out, cudaStream_t s) {
  switch (a_mode) {
    case A_CHUNKS: return launch_mode<BM, A_CHUNKS>(g, x, wp, N, Kp, e, out, s);
    case A_WORDS: return launch_mode<BM, A_WORDS>(g, x, wp, N, Kp, e, out, s);
    default: return launch_mode<BM, A_BYTES>(g, x, wp, N, Kp, e, out, s);
  }
}

}  // namespace

// wp: the weight packed (Cout, Kp), Kp = kh * kw * Cin rounded up to 16.
// a_mode: AMode; small_tile: 64 x 64 tiles instead of 128 x 64.
extern "C" int int8_conv_forward(
    const void* x, const void* wp, const float* scale, const float* bias,
    void* out, int batch, int H, int W, int Cin, int Cout, int kh, int kw,
    int sh, int sw, int pt, int pl, int Ho, int Wo, int out_kind, int relu,
    int a_mode, int small_tile, void* stream) {
  const int taps = BK / Cin;  // whole taps in a step of BK bytes
  const ConvGather g{H, W, Cin, kh, kw, Ho, Wo, sh, sw, pt, pl, batch * Ho * Wo,
                     BK % Cin, taps % kw, taps / kw, (W - kw) * Cin};
  const Epilogue e{scale, bias, out_kind, relu};
  const int Kp = (kh * kw * Cin + 15) / 16 * 16;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* xp = static_cast<const int8_t*>(x);
  const int8_t* wpp = static_cast<const int8_t*>(wp);
  return small_tile ? launch<64>(a_mode, g, xp, wpp, Cout, Kp, e, out, s)
                    : launch<128>(a_mode, g, xp, wpp, Cout, Kp, e, out, s);
}
