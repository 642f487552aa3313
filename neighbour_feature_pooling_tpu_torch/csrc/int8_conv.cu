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
// paper, the s8-out (chained) ones nearer to balance. This first version
// is bound by neither: it runs mma.sync (the tensor cores at part of their
// wgmma rate) from shared-memory tiles staged by ordinary loads.
//
// Design: an implicit GEMM (int8_mma.cuh). Row m of the GEMM is the output
// position (b, oy, ox); column k = (dy * kw + dx) * Cin + ci of the HWIO
// weight read as a (kh * kw * Cin, Cout) matrix. The gather below turns
// (m, k) into the input byte x[b, oy * sh - pt + dy, ox * sw - pl + dx, ci],
// or a zero outside the image, so the stride and the padding cost index
// math only: none of the TPU kernel's flattened rows with wrap-around
// columns, host padding or space-to-depth rewrite. With Cin % 16 == 0 a
// 16-byte chunk of k stays inside one tap; the RGB stem (Cin = 3) takes
// the byte path.
//
// C interface (bound with ctypes): int8_conv_forward returns the
// cudaError_t of the launch; it never synchronises and allocates nothing.

#include "int8_mma.cuh"

namespace {

using namespace int8k;

struct ConvGather {
  int H, W, Cin, K, kw, Ho, Wo, sh, sw, pt, pl, M;

  struct Tap {
    int dy, dx, ci;
    bool ok;
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
    r.base = (long long)b * H * W * Cin;
    r.iy0 = oy * sh - pt;
    r.ix0 = ox * sw - pl;
    return r;
  }

  __device__ Tap tap(int k) const {
    Tap t;
    t.ok = k < K;
    const int tp = k / Cin;
    t.ci = k - tp * Cin;
    t.dy = tp / kw;
    t.dx = tp - t.dy * kw;
    return t;
  }

  __device__ bool at(const Row& r, const Tap& t, long long& off) const {
    const int iy = r.iy0 + t.dy, ix = r.ix0 + t.dx;
    off = r.base + ((long long)iy * W + ix) * Cin + t.ci;
    return t.ok && (unsigned)iy < (unsigned)H && (unsigned)ix < (unsigned)W;
  }
};

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
int8_conv_kernel(ConvGather g, const int8_t* __restrict__ x,
                 const int8_t* __restrict__ w, int N, int vec_b, Epilogue e,
                 void* out) {
  __shared__ __align__(16) Smem sm;
  mma_tile<ConvGather, VEC>(g, x, w, g.M, N, g.K, vec_b != 0, e, out, sm);
}

}  // namespace

extern "C" int int8_conv_forward(
    const void* x, const void* w, const float* scale, const float* bias,
    void* out, int batch, int H, int W, int Cin, int Cout, int kh, int kw,
    int sh, int sw, int pt, int pl, int Ho, int Wo, int out_kind, int relu,
    int vec, void* stream) {
  const int M = batch * Ho * Wo;
  const ConvGather g{H, W, Cin, kh * kw * Cin, kw, Ho, Wo, sh, sw, pt, pl, M};
  const Epilogue e{scale, bias, out_kind, relu};
  const dim3 grid((M + BM - 1) / BM, (Cout + BN - 1) / BN);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* xp = static_cast<const int8_t*>(x);
  const int8_t* wp = static_cast<const int8_t*>(w);
  const int vec_b = Cout % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 4 == 0;
  if (vec)
    int8_conv_kernel<true><<<grid, kThreads, 0, s>>>(g, xp, wp, Cout, vec_b, e, out);
  else
    int8_conv_kernel<false><<<grid, kThreads, 0, s>>>(g, xp, wp, Cout, vec_b, e, out);
  return (int)cudaGetLastError();
}
