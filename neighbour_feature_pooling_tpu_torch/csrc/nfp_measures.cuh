// NFP measure arithmetic and staging helpers shared by the CUDA kernels
// nfp_small.cu (K1) and nfp_strips.cuh (the strip kernel of K2, nfp_large.cu,
// and K3, nfp_strip.cu).
//
// Every measure but pearson and mahalanobis is a sum over channels of
// per-channel terms (up to three accumulators) followed by a scalar tail:
// ops/measures.py::SEPARABLE, term for term (add_terms = map_terms,
// finish = finalize_sums). apply_finalize is the sign convention
// (Measure.finalize). src_index is ops/neighborhood.py::pad_index: padding
// is applied in the loads, so no padded copy of the map is ever written.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace nfp {

// keep in sync with ops/nfp_cuda.py::_MEASURE_IDS
enum Measure {
  NORM = 0, COSINE, DOT, RMSE, GEMAN, EMD, CANBERRA, HELLINGER, CHISQ1,
  CHISQ2, GFC, PEARSON, JEFFREY, SQUAREDCHORD, SMITH, SCS
};
// keep in sync with ops/nfp_cuda.py::_FINALIZE_IDS
enum Finalize { NEG_IF_SIM = 0, NEG_IF_DIST, ONE_MINUS_IF_DIST };
// keep in sync with ops/neighborhood.py::PAD_MODES
enum PadMode { ZEROS = 0, REFLECT, REPLICATE, CIRCULAR };

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

// Sum over each aligned group of G lanes (G a power of two up to 32);
// every lane of the group gets it. The whole warp must call it.
template <int G>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// 16-byte cp.async from global to shared memory; an invalid source reads
// as zeros (source size 0) and is never dereferenced.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

// Calls f(c, n) for every channel that thread `lane` of `lanes` owns: with
// a.vec, 16-byte chunks lane, lane + lanes, ...; else single channels. A
// null pixel reads as zeros.
template <typename T, typename F>
__device__ __forceinline__ void for_channels(const T* pc, const T* pn,
                                             const Args& a, int lane,
                                             int lanes, F&& f) {
  if (a.vec) {
    constexpr int V = Load<T>::kVec;
    float cv[V], nv[V];
    for (int c0 = lane * V; c0 < a.C; c0 += lanes * V) {
      if (pc) Load<T>::vec(pc + c0, cv);
      else for (int k = 0; k < V; ++k) cv[k] = 0.f;
      if (pn) Load<T>::vec(pn + c0, nv);
      else for (int k = 0; k < V; ++k) nv[k] = 0.f;
#pragma unroll
      for (int k = 0; k < V; ++k) f(cv[k], nv[k]);
    }
  } else {
    for (int c0 = lane; c0 < a.C; c0 += lanes) {
      f(pc ? Load<T>::one(pc + c0) : 0.f, pn ? Load<T>::one(pn + c0) : 0.f);
    }
  }
}

// Per-channel addends of each separable measure (SEPARABLE.map_terms).
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
    case JEFFREY: {  // pairwise form; the table's (pa - pb) * l in rounding
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

// scs' tail on the cosine: sign(cos) |cos|^p, NaN/Inf scrubbed to 0.
__device__ __forceinline__ float scs_sharpen(float cos, float p) {
  const float mag = powf(fabsf(cos), p);
  const float v = cos > 0.f ? mag : (cos < 0.f ? -mag : 0.f);
  return isfinite(v) ? v : 0.f;
}

// Pairwise tail: channel sums -> measure value (SEPARABLE.finalize_sums;
// PEARSON is K1's centred two-pass form).
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
    case SCS: return scs_sharpen(s0 / ((sqrtf(s1) + a.q_scs) * (sqrtf(s2) + a.q_scs)), a.p);
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

}  // namespace nfp
