// The large-map NFP strip kernel for Hopper (sm_90a), shared by K2
// (nfp_large.cu: the separable measures) and K3 (nfp_strip.cu: every
// stat-free measure, pearson included). Each source instantiates the
// template for its measures and binds its own C entry.
//
// Design:
//  * The TPU bodies put W on the vector lanes (_nfp_kernel_chw) or walk H
//    in strips to fit the scoped VMEM (_nfp_kernel); nothing of either is
//    carried over.
//  * A strip of rows across blocks, in steps. A block takes `rows`
//    consecutive output rows of one image over `cols` output columns (the
//    full width unless the plan cuts column tiles), `step` rows at a time;
//    the grid is (strips x column tiles, B). The plan (rows, step, cols,
//    channel chunk, lanes per position G, staged pixel stride) is chosen in
//    Python, ops/nfp_cuda.py::_k2_plan, and passed in.
//  * The padded window, staged once, as a ring of rows. The block copies
//    the input rows its pairs read, padding applied (src_index, the rule of
//    ops/neighborhood.py::pad_index, once per window row and column), into
//    shared memory in the input dtype: 16-byte cp.async where the channels
//    and the pointer allow it (a zero pixel is a copy of source size 0),
//    plain loads otherwise (the last vector's tail zero-filled, which adds 0
//    to every separable measure's sums; pearson masks it). An NHWC row is
//    one contiguous run, so the copy is coalesced. The next step's rows
//    load while a step computes, into the ring slots of rows no longer
//    needed; each input row is read once per block. The pair loop does no
//    global reads. A window above the plan's budget is staged one channel
//    chunk at a time, one step a block; each pair's chunk sums are added in
//    chunk order in shared memory.
//  * A lane group per output position, the centre in registers. G lanes
//    (1..32) take one position; lane l owns the staged 16-byte vectors l,
//    l + G, ... of a pixel (at most 16 floats). The group loads the centre
//    pixel's vectors into registers once and walks the k*k-1 neighbours from
//    shared memory, four at a time: 9 pixel reads per 8 pairs at R=1. The
//    staged pixel stride (in 16-byte vectors) is G times an odd number where
//    G < 8, so the 8 lanes of a quarter-warp read 8 distinct 16-byte bank
//    groups. Groups reduce with a loop of xor shuffles (group_sum<G>'s tree).
//  * The measure is a template parameter (one instance per measure and
//    dtype), so add_terms' and finish's switches fold out of the loops.
//  * Per-pixel sums once per staged pixel: cosine, gfc and scs need each
//    pixel's sum of squares, smith its sum of |x|. A group computes them
//    for every window pixel as it is staged, with the pairs' lane split and
//    xor tree, and keeps the part of the tail that depends on the pixel alone
//    (cosine's max(sqrt(s), eps)), so a pair sums one term per channel (the
//    dot, or the min) and its tail does the same operations as finish().
//  * Pearson is cosine on mean-centred pixels. A group first sums a staged
//    pixel's channels for its mean, then its squared deviations from that
//    mean; the pixel keeps both floats (the tail is the centred sum itself,
//    no square root). A pair centres the centre pixel once in registers and
//    each neighbour's values as it reads them, so it adds one product per
//    channel, and its tail s0 / sqrtf(tc * tn + eps) is finish()'s PEARSON
//    case. With a chunked C every chunk's sum is needed before any centred
//    sum: a means round stages the chunks in turn and adds each pixel's
//    channel sums in chunk order, then the main round stages them again for
//    the centred sums and the pairs, also in chunk order.
//  * Fused GAP in a fixed order, no atomics on values: each value is
//    finalized first (as K1 and the plain version do; the TPU bodies
//    finalize the mean instead, which agrees up to rounding); each step
//    sums its positions' values per neighbour (lanes over positions in
//    order, then a warp xor tree), the steps add in order into one partial
//    per (image, strip). In the same launch, the image's last block to
//    finish (an arrival counter per image, which the wrapper keeps zeroed
//    and that block resets) adds the image's partials in a fixed order (a
//    warp per neighbour, its lanes over the strips t = lane, lane + 32, ...
//    in order, then a warp xor tree) and divides; the counter only picks the
//    block, so results repeat bit for bit. The map form writes each output
//    row's values (k*k-1 per position, a multiple of 8 floats) with 16-byte
//    stores.
//  * Output is fp32: (B, N) with fuse_gap, else (B, H', W', N); the Python
//    wrapper casts it to the input dtype.
//
// Each C entry returns the cudaError_t of its launch; it never synchronises
// and allocates nothing (the wrapper passes the partial-sum buffer, one row
// per strip, and the zeroed arrival counters, one per image).

#pragma once

#include "nfp_measures.cuh"

namespace {  // internal linkage: each source keeps its own instances

using namespace nfp;

constexpr int kThreads = 256;         // ops/nfp_cuda.py::_K2_THREADS
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSmem = 227 * 1024;  // a block's shared memory on sm_90
constexpr int kLaneFloats = 16;       // centre floats a lane holds: _K2_LANE_FLOATS
constexpr int kNb = 4;                // neighbours a group takes at once; 4R(R+1) is a multiple

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

// How a launch is cut; ops/nfp_cuda.py::K2Plan. A block takes `rows` output
// rows over `cols` output columns, `step` rows at a time.
struct Plan {
  int rows, step, cols, chunk, group, stride;  // stride: 16-byte vectors per staged pixel
};

// Window rows a block holds: an iteration's step + span rows, and the next
// iteration's step rows while they load.
__host__ __device__ inline int ring_rows(const Plan& pl, int span) {
  return (pl.rows > pl.step ? 2 * pl.step : pl.step) + span;
}

// Byte offsets of a block's shared memory; ops/nfp_cuda.py::_k2_smem_bytes.
// `means`: a second float per ring pixel, pearson's channel means.
struct Layout {
  size_t tails, means, vals, index, total;
};

__host__ __device__ inline Layout smem_layout(const Args& a, const Plan& pl, bool means) {
  const int k = 2 * a.radius + 1;
  const int span = (k - 1) * a.dilation;
  const size_t n_pix = (size_t)ring_rows(pl, span) * (pl.cols + span);
  Layout L;
  L.tails = n_pix * pl.stride * 16;                                  // the window ring
  L.means = L.tails + align16(n_pix * sizeof(float));                // per-pixel tails
  L.vals = L.means + (means ? align16(n_pix * sizeof(float)) : 0);   // per-pixel means
  L.index = L.vals + align16((size_t)pl.step * pl.cols * (k * k - 1) * sizeof(float));
  L.total = L.index + align16((size_t)(pl.rows + span + pl.cols + span + 3 * (k * k - 1) + 1) *
                              sizeof(int));
  return L;
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {  // all but the N latest groups landed
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Starts the copy of channels [c0, c0 + chunk) of window rows [u0, u1) into
// their ring slots (row u in slot u % ring, pixel-major, `pix` elements
// apart) as one cp.async group; a pixel with a negative source row or column
// is zeros. Without a.vec the copy is done with plain loads and stores, the
// last vector's tail zero-filled. A thread keeps one copy index within a
// pixel and walks pixels, so no copy costs a division.
template <typename T>
__device__ void load_rows(T* win, const T* img, const int* src_row, const int* src_col,
                          const Args& a, int u0, int u1, int ring, int win_cols, int c0,
                          int chunk, int pix) {
  constexpr int V = Load<T>::kVec;
  const int per_pix = a.vec ? chunk / V : (chunk + V - 1) / V * V;  // copies per pixel
  const int per_thread = (per_pix + kThreads - 1) / kThreads;  // > 1 only for wide scalar chunks
  const int lanes = per_pix / per_thread;  // threads per pixel
  const int pixels = kThreads / lanes;     // pixels a pass of the block covers
  const int e0 = threadIdx.x % lanes, v0 = threadIdx.x / lanes;
  if (v0 >= pixels) return cp_async_commit();
  for (int u = u0; u < u1; ++u) {
    const int sr = src_row[u];
    T* row = win + (long long)(u % ring) * win_cols * pix;
    for (int v = v0; v < win_cols; v += pixels) {
      const int sc = src_col[v];
      const bool valid = sr >= 0 && sc >= 0;
      const T* src = img + ((long long)sr * a.W + sc) * a.C + c0;
      T* dst = row + v * pix;
      for (int e = e0; e < per_pix; e += lanes) {
        if (a.vec) {
          cp_async16(dst + e * V, valid ? src + e * V : img, valid);
        } else {
          dst[e] = (e < chunk && valid) ? src[e] : static_cast<T>(0.f);
        }
      }
    }
  }
  cp_async_commit();
}

// Sums each value over its aligned group of G lanes (a power of two, 1 to
// 32) with group_sum<G>'s xor tree, in a loop rather than a switch on G, so
// that no indirect branch sits in the pair loop. The whole warp calls it.
template <int N>
__device__ __forceinline__ void group_sums(float (&v)[N], int G) {
  for (int o = G >> 1; o > 0; o >>= 1) {
#pragma unroll
    for (int j = 0; j < N; ++j) v[j] += __shfl_xor_sync(0xffffffffu, v[j], o);
  }
}

// The measures whose tail needs each pixel's own sum (s1 of the centre, s2
// of the neighbour), that sum's per-channel term, and the part of the tail
// that depends on one pixel alone, applied once per pixel.
template <int M>
constexpr bool kPixelSums = M == COSINE || M == GFC || M == SCS || M == SMITH;

template <int M>
__device__ __forceinline__ float pixel_term(float v) {
  return M == SMITH ? fabsf(v) : v * v;
}

template <int M>
__device__ __forceinline__ float pixel_tail(const Args& a, float s) {
  switch (M) {
    case COSINE: return fmaxf(sqrtf(s), a.eps);
    case GFC: return sqrtf(s);
    case SCS: return sqrtf(s) + a.q_scs;
    default: return s;  // SMITH
  }
}

// finish() on a pair's sum and its two pixels' tails: the same operations
// in the same order, so the same float.
template <int M>
__device__ __forceinline__ float finish_pair(const Args& a, float s0, float tc, float tn) {
  switch (M) {
    case COSINE: return s0 / (tc * tn);
    case GFC: return s0 / (tc * tn + a.eps);
    case SCS: return scs_sharpen(s0 / (tc * tn), a.p);
    case SMITH: return 1.f - s0 / (fminf(tc, tn) + a.eps);
    case PEARSON: return s0 / sqrtf(tc * tn + a.eps);
    default: return finish(a, s0, 0.f, 0.f);
  }
}

// pearson's per-pixel pass over one staged pixel `px`, lane `lane` of its
// group of G taking the vectors lane, lane + G, ... of `units`. In the means
// round, add the pixel's channel sum to *mean (chunks in chunk order; the
// mean once the last chunk is in). Else take its mean first where the whole
// pixel is staged (n_chunks == 1), then its centred sum of squares into
// *tail, the pixel's tail (chunks in chunk order); a scalar chunk's
// zero-filled tail is no channel. The whole warp calls it; lane 0 writes.
template <typename T>
__device__ __forceinline__ void pearson_pixel(const T* px, float* mean, float* tail, bool live,
                                              bool means_round, int ch, bool last, int n_chunks,
                                              int C, int chunk, int units, int lane, int G) {
  constexpr int V = Load<T>::kVec;
  constexpr int kSlots = kLaneFloats / V;
  float s[1] = {0.f};
  if (live && (means_round || n_chunks == 1)) {
#pragma unroll
    for (int sl = 0; sl < kSlots; ++sl) {
      const int vu = lane + sl * G;
      if (vu < units) {
        float x4[V];
        Load<T>::vec(px + vu * V, x4);
#pragma unroll
        for (int e = 0; e < V; ++e) s[0] += x4[e];
      }
    }
  }
  float m = 0.f;
  if (means_round || n_chunks == 1) {
    group_sums(s, G);
    if (means_round) {
      if (lane == 0 && live) {
        const float sum = ch > 0 ? *mean + s[0] : s[0];
        *mean = last ? sum / C : sum;
      }
      return;
    }
    m = s[0] / C;
    s[0] = 0.f;
  } else if (live) {
    m = *mean;
  }
  if (live) {
#pragma unroll
    for (int sl = 0; sl < kSlots; ++sl) {
      const int vu = lane + sl * G;
      if (vu < units) {
        float x4[V];
        Load<T>::vec(px + vu * V, x4);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float d = vu * V + e < chunk ? x4[e] - m : 0.f;
          s[0] += d * d;
        }
      }
    }
  }
  group_sums(s, G);
  if (lane == 0 && live) {
    if (n_chunks == 1) *mean = m;
    *tail = ch > 0 ? *tail + s[0] : s[0];
  }
}

template <typename T, int M>
__global__ void __launch_bounds__(kThreads, 2)
nfp_strips_kernel(const T* __restrict__ x, float* __restrict__ out,
                  float* __restrict__ partial, int* __restrict__ arrived, Args a, Plan pl) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int V = Load<T>::kVec;
  constexpr int kSlots = kLaneFloats / V;  // 16-byte vectors a lane holds
  Args am = a;
  am.measure = M;  // a constant: add_terms' and finish's switches fold

  const int k = 2 * a.radius + 1;
  const int n_nb = k * k - 1;
  const int centre = (k * k) / 2;  // row-major index of the centre tap
  const int span = (k - 1) * a.dilation;
  const int r = a.radius * a.dilation;
  const int n_cols = (a.Wo + pl.cols - 1) / pl.cols;
  const int strip = blockIdx.x / n_cols, ct = blockIdx.x - strip * n_cols;
  const long long b = blockIdx.y;
  const int oh0 = strip * pl.rows, ow0 = ct * pl.cols;
  const int rows = min(pl.rows, a.Ho - oh0);  // the last strip and tile may be ragged
  const int cols = min(pl.cols, a.Wo - ow0);
  const int win_cols = cols + span;
  const int ring = ring_rows(pl, span);
  const int n_iter = (rows + pl.step - 1) / pl.step;
  const int units = (pl.chunk + V - 1) / V;  // staged 16-byte vectors per pixel
  const int n_chunks = a.C / pl.chunk;
  const int pix = pl.stride * V;             // elements per staged pixel

  const Layout L = smem_layout(a, pl, M == PEARSON);
  T* win = reinterpret_cast<T*>(smem);
  float* tails = reinterpret_cast<float*>(smem + L.tails);
  float* means = reinterpret_cast<float*>(smem + L.means);  // pearson only
  float* vals = reinterpret_cast<float*>(smem + L.vals);
  int* src_row = reinterpret_cast<int*>(smem + L.index);
  int* src_col = src_row + rows + span;
  int* nb_row = src_col + win_cols;  // a neighbour's window row and column
  int* nb_col = nb_row + n_nb;       // from the position's tap (0, 0)
  float* gap = reinterpret_cast<float*>(nb_col + n_nb);  // this block's sum per neighbour
  int* reduce_here = reinterpret_cast<int*>(gap + n_nb);  // fused GAP: the image's last block
  const T* img = x + b * a.H * a.W * a.C;

  for (int u = threadIdx.x; u < rows + span; u += kThreads)
    src_row[u] = src_index(oh0 + u - a.padding, a.H, a.pad_mode);
  for (int v = threadIdx.x; v < win_cols; v += kThreads)
    src_col[v] = src_index(ow0 + v - a.padding, a.W, a.pad_mode);
  for (int nb = threadIdx.x; nb < n_nb; nb += kThreads) {
    const int t = nb < centre ? nb : nb + 1;
    nb_row[nb] = t / k * a.dilation;
    nb_col[nb] = t % k * a.dilation;
  }
  __syncthreads();

  // apply_finalize(v) as sign * v + offset: -v, v or 1 - v
  const float offset = apply_finalize(a, 0.f), sign = apply_finalize(a, 1.f) - offset;
  const int G = pl.group;
  const int lane = threadIdx.x & (G - 1);
  const int g = threadIdx.x / G, n_groups = kThreads / G;
  const int warp = threadIdx.x >> 5, lane32 = threadIdx.x & 31;

  // A chunked pearson stages its chunks twice, one step a block: first a
  // means round (kc < 0) for each pixel's channel mean, since every chunk's
  // sum is needed before any centred sum, then the main round. Every other
  // launch takes the main round only.
  const int k0 = M == PEARSON && n_chunks > 1 ? -n_chunks : 0;
  for (int kc = k0; kc < n_chunks; ++kc) {
    const bool means_round = M == PEARSON && kc < 0;
    const int ch = means_round ? kc + n_chunks : kc;
    const int c0 = ch * pl.chunk;
    const bool last = ch + 1 == n_chunks;
    load_rows(win, img, src_row, src_col, a, 0, min(pl.step, rows) + span, ring, win_cols,
              c0, pl.chunk, pix);
    for (int it = 0; it < n_iter; ++it) {
      const int h0 = it * pl.step;  // the iteration's first output row in the block
      const int st = min(pl.step, rows - h0);
      if (it + 1 < n_iter) {  // the next iteration's rows load during this one
        const int h1 = h0 + pl.step;
        load_rows(win, img, src_row, src_col, a, h1 + span, h1 + min(pl.step, rows - h1) + span,
                  ring, win_cols, c0, pl.chunk, pix);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();

      if constexpr (kPixelSums<M> || M == PEARSON) {  // each newly staged pixel's sums,
        const int u1 = h0 + st + span;                  // then its tail
        int u = it == 0 ? 0 : h0 + span, v = g, slot = u % ring;  // this group's pixel
        while (v >= win_cols) { v -= win_cols; ++u; slot = slot + 1 == ring ? 0 : slot + 1; }
        for (int p0 = (it == 0 ? 0 : h0 + span) * win_cols; p0 < u1 * win_cols; p0 += n_groups) {
          const bool live_p = u < u1;
          const int q = slot * win_cols + v;
          if constexpr (M == PEARSON) {
            pearson_pixel(win + (long long)q * pix, means + q, tails + q, live_p, means_round,
                          ch, last, n_chunks, a.C, pl.chunk, units, lane, G);
          } else {
            float s[1] = {0.f};
            if (live_p) {
              const T* px = win + (long long)q * pix;
#pragma unroll
              for (int sl = 0; sl < kSlots; ++sl) {
                const int vu = lane + sl * G;
                if (vu < units) {
                  float x4[V];
                  Load<T>::vec(px + vu * V, x4);
#pragma unroll
                  for (int e = 0; e < V; ++e) s[0] += pixel_term<M>(x4[e]);
                }
              }
            }
            group_sums(s, G);
            if (lane == 0 && live_p) {
              const float sum = ch > 0 ? tails[q] + s[0] : s[0];  // chunks in chunk order
              tails[q] = last ? pixel_tail<M>(am, sum) : sum;
            }
          }
          for (v += n_groups; v >= win_cols; v -= win_cols) {
            ++u;
            slot = slot + 1 == ring ? 0 : slot + 1;
          }
        }
        __syncthreads();
      }
      if (means_round) continue;  // the ring is free for the next chunk

      const int n_pos = st * cols;
      int lc = g, u = h0 % ring;  // this group's column and the ring slot of
      while (lc >= cols) {        // its window row at tap (0, 0)
        lc -= cols;
        u = u + 1 == ring ? 0 : u + 1;
      }
      for (int pos = g; pos - g < n_pos; pos += n_groups) {
        const bool live = pos < n_pos;
        const int pc = (u + r < ring ? u + r : u + r - ring) * win_cols + lc + r;
        float cv[kSlots][V];  // this lane's share of the centre pixel
        float mc = 0.f;       // pearson: the centre's mean
        if constexpr (M == PEARSON) {
          if (live) mc = means[pc];
        }
#pragma unroll
        for (int sl = 0; sl < kSlots; ++sl) {
          const int vu = lane + sl * G;
          if (live && vu < units) {
            Load<T>::vec(win + (long long)pc * pix + vu * V, cv[sl]);
            if constexpr (M == PEARSON) {  // centred once; a scalar chunk's tail is 0
#pragma unroll
              for (int e = 0; e < V; ++e) cv[sl][e] = vu * V + e < pl.chunk ? cv[sl][e] - mc : 0.f;
            }
          } else {
#pragma unroll
            for (int e = 0; e < V; ++e) cv[sl][e] = 0.f;
          }
        }
        for (int nb0 = 0; nb0 < n_nb; nb0 += kNb) {
          float s0[kNb];
          int pn[kNb];
#pragma unroll
          for (int j = 0; j < kNb; ++j) {
            const int un = u + nb_row[nb0 + j];
            pn[j] = (un < ring ? un : un - ring) * win_cols + lc + nb_col[nb0 + j];
            s0[j] = 0.f;
          }
          if (live) {
            float s1 = 0.f, s2 = 0.f;  // unused: the pixel tails stand in
            float mn[kNb] = {0.f, 0.f, 0.f, 0.f};  // pearson: the neighbours' means
            if constexpr (M == PEARSON) {
#pragma unroll
              for (int j = 0; j < kNb; ++j) mn[j] = means[pn[j]];
            }
#pragma unroll
            for (int sl = 0; sl < kSlots; ++sl) {
              const int vu = lane + sl * G;
              if (vu < units) {
#pragma unroll
                for (int j = 0; j < kNb; ++j) {
                  float nv[V];
                  Load<T>::vec(win + (long long)pn[j] * pix + vu * V, nv);
#pragma unroll
                  for (int e = 0; e < V; ++e) {
                    if constexpr (M == PEARSON) {
                      s0[j] += cv[sl][e] * (nv[e] - mn[j]);
                    } else {
                      add_terms(am, cv[sl][e], nv[e], s0[j], s1, s2);
                    }
                  }
                }
              }
            }
          }
          group_sums(s0, G);
          if (lane == 0 && live) {
            float4* vq = reinterpret_cast<float4*>(vals + pos * n_nb + nb0);
            float4 v4 = make_float4(s0[0], s0[1], s0[2], s0[3]);
            if (ch > 0) {  // chunk sums in chunk order
              const float4 o = *vq;
              v4 = make_float4(o.x + v4.x, o.y + v4.y, o.z + v4.z, o.w + v4.w);
            }
            if (last) {  // the tail, then the sign convention as one fma (exact)
              const float tc = tails[pc];
              v4.x = fmaf(sign, finish_pair<M>(am, v4.x, tc, tails[pn[0]]), offset);
              v4.y = fmaf(sign, finish_pair<M>(am, v4.y, tc, tails[pn[1]]), offset);
              v4.z = fmaf(sign, finish_pair<M>(am, v4.z, tc, tails[pn[2]]), offset);
              v4.w = fmaf(sign, finish_pair<M>(am, v4.w, tc, tails[pn[3]]), offset);
            }
            *vq = v4;
          }
        }
        for (lc += n_groups; lc >= cols; lc -= cols) u = u + 1 == ring ? 0 : u + 1;
      }
      __syncthreads();

      if (last && !a.fuse_gap) {  // (B, H', W', N): each output row is one contiguous run
        const int run = cols * n_nb / 4;  // float4s
        for (int i = threadIdx.x; i < st * run; i += kThreads) {
          const int lr = i / run, e = i - lr * run;
          reinterpret_cast<float4*>(out + ((b * a.Ho + oh0 + h0 + lr) * a.Wo + ow0) * n_nb)[e] =
              reinterpret_cast<const float4*>(vals + lr * cols * n_nb)[e];
        }
      } else if (last) {  // per neighbour: lanes over positions in order, a warp tree,
        for (int nb = warp; nb < n_nb; nb += kWarps) {  // then the iterations in order
          float s = 0.f;
          for (int pos = lane32; pos < n_pos; pos += 32) s += vals[pos * n_nb + nb];
          s = warp_sum(s);
          if (lane32 == 0) gap[nb] = it == 0 ? s : gap[nb] + s;
        }
      }
    }
  }
  if (a.fuse_gap) {  // this strip's partial, then the image's last block reduces
    __syncthreads();
    float* img_partial = partial + b * gridDim.x * n_nb;
    for (int nb = threadIdx.x; nb < n_nb; nb += kThreads)
      img_partial[blockIdx.x * n_nb + nb] = gap[nb];
    __threadfence();  // the partial is visible before this block is counted
    __syncthreads();
    if (threadIdx.x == 0) *reduce_here = atomicAdd(arrived + b, 1) + 1u == gridDim.x;
    __syncthreads();
    if (!*reduce_here) return;
    __threadfence();
    // a warp per neighbour, lanes over the strips in order, a warp tree; the
    // counter only picks the block, so the sum repeats bit for bit
    for (int nb = warp; nb < n_nb; nb += kWarps) {
      float s = 0.f;
      for (int t = lane32; t < gridDim.x; t += 32) s += __ldcg(img_partial + t * n_nb + nb);
      s = warp_sum(s);
      if (lane32 == 0) out[b * n_nb + nb] = s / (float)(a.Ho * a.Wo);
    }
    if (threadIdx.x == 0) arrived[b] = 0;  // ready for the next launch
  }
}

template <typename T, int M>
int launch(const void* x, void* out, void* partial, void* arrived, int batch,
           const Args& a, const Plan& pl, cudaStream_t stream) {
  constexpr int V = Load<T>::kVec;
  const int units = (pl.chunk + V - 1) / V;
  if (pl.rows < 1 || pl.step < 1 || pl.step > pl.rows || pl.cols < 1 || pl.chunk < 1 ||
      a.C % pl.chunk || (a.C != pl.chunk && pl.step != pl.rows) ||
      (a.vec && pl.chunk % V) || pl.group < 1 || pl.group > 32 ||
      (pl.group & (pl.group - 1)) || pl.stride < units ||
      units > pl.group * (kLaneFloats / V))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_layout(a, pl, M == PEARSON).total;
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    static const cudaError_t allowed = cudaFuncSetAttribute(
        nfp_strips_kernel<T, M>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (allowed != cudaSuccess) return (int)allowed;
  }
  const int n_blocks = ((a.Ho + pl.rows - 1) / pl.rows) * ((a.Wo + pl.cols - 1) / pl.cols);
  nfp_strips_kernel<T, M><<<dim3(n_blocks, batch), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<float*>(out), static_cast<float*>(partial),
      static_cast<int*>(arrived), a, pl);
  return (int)cudaGetLastError();
}

// launch<T, M> for a.measure: the separable measures
// (ops/measures.py::SEPARABLE), and pearson where kPearson; any other
// measure is an invalid value.
template <typename T, bool kPearson>
int dispatch(const void* x, void* out, void* partial, void* arrived, int batch,
             const Args& a, const Plan& pl, cudaStream_t s) {
#define NFP_STRIPS_CASE(m) \
  case m: return launch<T, m>(x, out, partial, arrived, batch, a, pl, s);
  switch (a.measure) {
    NFP_STRIPS_CASE(NORM) NFP_STRIPS_CASE(COSINE) NFP_STRIPS_CASE(DOT) NFP_STRIPS_CASE(RMSE)
    NFP_STRIPS_CASE(GEMAN) NFP_STRIPS_CASE(EMD) NFP_STRIPS_CASE(CANBERRA)
    NFP_STRIPS_CASE(HELLINGER) NFP_STRIPS_CASE(CHISQ1) NFP_STRIPS_CASE(CHISQ2)
    NFP_STRIPS_CASE(GFC) NFP_STRIPS_CASE(JEFFREY) NFP_STRIPS_CASE(SQUAREDCHORD)
    NFP_STRIPS_CASE(SMITH) NFP_STRIPS_CASE(SCS)
    case PEARSON:
      if constexpr (kPearson) return launch<T, PEARSON>(x, out, partial, arrived, batch, a, pl, s);
      return (int)cudaErrorInvalidValue;
    default: return (int)cudaErrorInvalidValue;
  }
#undef NFP_STRIPS_CASE
}

// The C entries' body: nfp_large_forward (kPearson false) and
// nfp_strip_forward (true) take the same arguments.
template <bool kPearson>
int strips_forward(const void* x, void* out, void* partial, void* arrived, int is_bf16,
                   int batch, const Args& a, const Plan& pl, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return dispatch<__nv_bfloat16, kPearson>(x, out, partial, arrived, batch, a, pl, s);
  return dispatch<float, kPearson>(x, out, partial, arrived, batch, a, pl, s);
}

}  // namespace
