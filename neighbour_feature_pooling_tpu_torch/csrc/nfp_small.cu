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
//
// C interface (bound with ctypes): nfp_small_forward returns the
// cudaError_t of the launch; it never synchronises and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// keep in sync with ops/nfp_cuda.py::_MEASURE_IDS
enum Measure {
  NORM = 0, COSINE, DOT, RMSE, GEMAN, EMD, CANBERRA, HELLINGER, CHISQ1,
  CHISQ2, GFC, PEARSON, JEFFREY, SQUAREDCHORD, SMITH, SCS
};
// keep in sync with ops/nfp_cuda.py::_FINALIZE_IDS
enum Finalize { NEG_IF_SIM = 0, NEG_IF_DIST, ONE_MINUS_IF_DIST };
// keep in sync with ops/neighborhood.py::PAD_MODES
enum PadMode { ZEROS = 0, REFLECT, REPLICATE, CIRCULAR };

constexpr int kThreads = 1024;

struct Args {
  int H, W, C, Ho, Wo, radius, dilation, padding, pad_mode;
  int measure, finalize, similarity, fuse_gap, vec;
  float p, eps, q_scs;
};

template <typename T> struct Load;

template <> struct Load<float> {
  static constexpr int kVec = 4;
  __device__ static void vec(const float* ptr, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(ptr);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
  __device__ static float one(const float* ptr) { return *ptr; }
};

template <> struct Load<__nv_bfloat16> {
  static constexpr int kVec = 8;
  __device__ static void vec(const __nv_bfloat16* ptr, float* out) {
    const uint4 raw = *reinterpret_cast<const uint4*>(ptr);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      out[2 * k] = f.x;
      out[2 * k + 1] = f.y;
    }
  }
  __device__ static float one(const __nv_bfloat16* ptr) {
    return __bfloat162float(*ptr);
  }
};

// Source index of position i on an axis of length n, as jnp.pad fills it;
// -1 means a zero (zeros padding).
__device__ __forceinline__ int src_index(int i, int n, int mode) {
  if (i >= 0 && i < n) return i;
  switch (mode) {
    case ZEROS: return -1;
    case REPLICATE: return i < 0 ? 0 : n - 1;
    case CIRCULAR: { const int m = i % n; return m < 0 ? m + n : m; }
    default: {  // REFLECT: period 2(n-1); a length-1 axis repeats
      if (n == 1) return 0;
      const int period = 2 * (n - 1);
      int m = i % period;
      if (m < 0) m += period;
      return m >= n ? period - m : m;
    }
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Calls f(c, n) for every channel this lane owns; a null pixel is zeros.
template <typename T, typename F>
__device__ __forceinline__ void for_channels(const T* pc, const T* pn,
                                             const Args& a, int lane, F&& f) {
  if (a.vec) {
    constexpr int V = Load<T>::kVec;
    float cv[V], nv[V];
    for (int c0 = lane * V; c0 < a.C; c0 += 32 * V) {
      if (pc) Load<T>::vec(pc + c0, cv);
      else for (int k = 0; k < V; ++k) cv[k] = 0.f;
      if (pn) Load<T>::vec(pn + c0, nv);
      else for (int k = 0; k < V; ++k) nv[k] = 0.f;
#pragma unroll
      for (int k = 0; k < V; ++k) f(cv[k], nv[k]);
    }
  } else {
    for (int c0 = lane; c0 < a.C; c0 += 32) {
      f(pc ? Load<T>::one(pc + c0) : 0.f, pn ? Load<T>::one(pn + c0) : 0.f);
    }
  }
}

// Per-channel addends of each measure (ops/measures.py, term for term).
__device__ __forceinline__ void add_terms(const Args& a, float c, float n,
                                          float& s0, float& s1, float& s2) {
  switch (a.measure) {
    case NORM: {
      const float d = fabsf(c - n);
      s0 += a.p == 1.f ? d : (a.p == 2.f ? d * d : powf(d, a.p));
      break;
    }
    case COSINE: case GFC: case SCS:
      s0 += c * n; s1 += c * c; s2 += n * n;
      break;
    case DOT:
      s0 += c * n;
      break;
    case RMSE: {
      const float d = c - n;
      s0 += d * d;
      break;
    }
    case GEMAN: {
      const float d = c - n;
      const float d2 = d * d;
      s0 += d2 / (d2 + a.eps);
      break;
    }
    case EMD:
      s0 += fabsf(c - n);
      break;
    case CANBERRA:
      s0 += fabsf(c - n) / (fabsf(c) + fabsf(n) + a.eps);
      break;
    case HELLINGER: case SQUAREDCHORD: {
      const float t = sqrtf(fabsf(c) + a.eps) - sqrtf(fabsf(n) + a.eps);
      s0 += t * t;
      break;
    }
    case CHISQ1: {
      const float d = c - n;
      s0 += d * d / (fabsf(c) + fabsf(n) + a.eps);
      break;
    }
    case CHISQ2: {
      const float d = c - n;
      s0 += d * d / (fabsf(c) + a.eps);
      break;
    }
    case JEFFREY: {
      const float pa = fabsf(c) + a.eps;
      const float pb = fabsf(n) + a.eps;
      const float l = logf(pa / pb);
      s0 += pa * l - pb * l;
      break;
    }
    case SMITH: {
      const float ca = fabsf(c), na = fabsf(n);
      s0 += fminf(ca, na); s1 += ca; s2 += na;
      break;
    }
    default:
      break;
  }
}

// Pairwise tail: channel sums -> measure value.
__device__ __forceinline__ float finish(const Args& a, float s0, float s1,
                                        float s2) {
  switch (a.measure) {
    case NORM:
      return a.p == 1.f ? s0 : (a.p == 2.f ? sqrtf(s0) : powf(s0, 1.f / a.p));
    case COSINE:
      return s0 / (fmaxf(sqrtf(s1), a.eps) * fmaxf(sqrtf(s2), a.eps));
    case RMSE: return sqrtf(s0 / a.C);
    case GEMAN: return s0 / a.C;
    case HELLINGER: return sqrtf(0.5f * s0);
    case GFC: return s0 / (sqrtf(s1) * sqrtf(s2) + a.eps);
    case PEARSON: return s0 / sqrtf(s1 * s2 + a.eps);
    case SMITH: return 1.f - s0 / (fminf(s1, s2) + a.eps);
    case SCS: {
      const float cos = s0 / ((sqrtf(s1) + a.q_scs) * (sqrtf(s2) + a.q_scs));
      const float mag = powf(fabsf(cos), a.p);
      const float v = cos > 0.f ? mag : (cos < 0.f ? -mag : 0.f);
      return isfinite(v) ? v : 0.f;  // NaN/Inf scrubbed to 0
    }
    default:  // DOT, EMD, CANBERRA, CHISQ1, CHISQ2, JEFFREY, SQUAREDCHORD
      return s0;
  }
}

__device__ __forceinline__ float apply_finalize(const Args& a, float v) {
  switch (a.finalize) {
    case NEG_IF_SIM: return a.similarity ? -v : v;
    case NEG_IF_DIST: return a.similarity ? v : -v;
    default: return a.similarity ? v : 1.f - v;
  }
}

// The finalized measure between two pixels; every lane returns it.
template <typename T>
__device__ float pair_value(const T* pc, const T* pn, const Args& a,
                            int lane) {
  float s0 = 0.f, s1 = 0.f, s2 = 0.f;
  if (a.measure == PEARSON) {
    for_channels(pc, pn, a, lane, [&](float c, float n) { s0 += c; s1 += n; });
    const float mc = warp_sum(s0) / a.C;
    const float mn = warp_sum(s1) / a.C;
    s0 = s1 = 0.f;
    for_channels(pc, pn, a, lane, [&](float c, float n) {
      const float cc = c - mc, nc = n - mn;
      s0 += cc * nc; s1 += cc * cc; s2 += nc * nc;
    });
  } else {
    for_channels(pc, pn, a, lane,
                 [&](float c, float n) { add_terms(a, c, n, s0, s1, s2); });
  }
  s0 = warp_sum(s0);
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  return apply_finalize(a, finish(a, s0, s1, s2));
}

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
