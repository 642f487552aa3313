// Small-map Neighborhood Feature Pooling (NFP) forward for Hopper (sm_90a).
//
// Replaces the TPU kernel neighbour_feature_pooling_tpu/ops/nfp_pallas.py::
// _nfp_kernel_unrolled: whole-image NFP for maps of at most 256 output
// positions (the texture heads: 7x7 ResNet, 14x14 ViT, the 14x14 and 7x7
// MobileNetV3 taps), stride 1, every stat-free measure, optionally fused
// with the global average pool.
//
// What bounds it: at the serving shape (B=32, 7x7x512 fp32, R=1) the op
// reads 3.2 MB once and does ~6 flops per channel per (position, neighbour)
// pair: memory-bound on paper (~1 us at 3.35 TB/s), under the ~5 us an
// empty launch reads on the timer. What holds this design back is one
// block's latency, ~7 us beyond that floor even for a single image: the
// window is staged, then the pairs run, then the tiles meet at a cluster
// barrier, one phase after another; and each pair reads both its pixels
// from shared memory, so the centre pixel is read once per neighbour.
// With blocks of ~100 KB (C=960) an image's 7-block cluster is hard to
// place at B=128, where the grid takes several waves (PERF.md §6).
//
// Design:
//  * Row tiles across blocks. A block takes `rows` consecutive output rows
//    of one image; the grid is n_tiles x B blocks, n_tiles <= 8. The plan
//    (rows, channel chunk, lane-group size) is chosen in Python,
//    ops/nfp_cuda.py::_k1_plan, and passed in.
//  * The padded window, staged once. The block copies the input rows and
//    columns its pairs read, padding applied (src_index, the rule of
//    ops/neighborhood.py::pad_index), into shared memory in the input
//    dtype: 16-byte cp.async where the channels allow it (zeros through
//    the copy's source size), scalar loads otherwise. The pair loop then
//    does no index arithmetic and reads no global memory. A window above
//    the plan's budget is staged one channel chunk at a time; each chunk's
//    channel sums are added, in chunk order, into a per-pair accumulator in
//    shared memory.
//  * A lane group per pair. G lanes (4..32) take one (position, neighbour)
//    pair, sum the measure's channel terms over the staged chunk
//    (for_channels, add_terms), reduce with group_sum<G>, and the group's
//    first lane applies finish and apply_finalize. The measure is a
//    template parameter, so add_terms' switch folds out of the channel loop.
//  * pearson: each staged pixel's channel mean is computed once per block,
//    in a first sweep over the window (over every chunk), into shared
//    memory; the pairs then take one centred pass.
//  * Fused GAP in one launch, in a fixed order, no atomics: an image's
//    tiles run as one thread-block cluster. Each tile sums its values per
//    neighbour in position order in its shared memory; after cluster.sync()
//    the cluster's first block reads the other tiles' sums through
//    distributed shared memory (map_shared_rank), adds them in tile order
//    and divides. Results repeat bit for bit. The map form writes
//    (B, H', W', N) from each group's first lane, without a cluster.
//  * Output is fp32; the Python wrapper casts it to the input dtype.
//
// C interface (bound with ctypes): nfp_small_forward returns the
// cudaError_t of the launches; it never synchronises and allocates nothing.

#include <cooperative_groups.h>

#include "nfp_measures.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace nfp;

constexpr int kThreads = 256;            // ops/nfp_cuda.py::_K1_THREADS
constexpr int kMaxSmem = 227 * 1024;     // a block's shared memory on sm_90

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

// Byte offsets of a block's shared memory; ops/nfp_cuda.py::_k1_smem_bytes
// is this layout's largest case (pearson, fused GAP).
struct Layout {
  size_t means, acc, vals, index, total;
};

__host__ __device__ inline Layout smem_layout(const Args& a, int rows, int chunk,
                                              int elem_bytes, bool pearson) {
  const int k = 2 * a.radius + 1;
  const int span = (k - 1) * a.dilation;
  const size_t n_pix = (size_t)(rows + span) * (a.Wo + span);
  const size_t n_pairs = (size_t)rows * a.Wo * (k * k - 1);
  Layout L;
  L.means = align16(n_pix * chunk * elem_bytes);                  // the window
  L.acc = L.means + (pearson ? align16(n_pix * sizeof(float)) : 0);
  L.vals = L.acc + (a.C / chunk > 1 ? align16(n_pairs * 3 * sizeof(float)) : 0);
  L.index = L.vals + (a.fuse_gap ? align16(n_pairs * sizeof(float)) : 0);
  L.total = L.index + align16((size_t)(rows + span + a.Wo + span) * sizeof(int));
  return L;
}

// Copies channels [c0, c0 + chunk) of the window's n_pix pixels into win
// (pixel-major, chunk channels each); a pixel with a negative source row or
// column is zeros. Ends with a block-wide barrier.
template <typename T>
__device__ void stage(T* win, const T* img, const int* src_row, const int* src_col,
                      const Args& a, int n_pix, int win_cols, int c0, int chunk) {
  if (a.vec) {
    constexpr int V = Load<T>::kVec;
    const int nvec = chunk / V;
    for (int i = threadIdx.x; i < n_pix * nvec; i += blockDim.x) {
      const int p = i / nvec, cv = i - p * nvec;
      const int u = p / win_cols;
      const int sr = src_row[u], sc = src_col[p - u * win_cols];
      const bool valid = sr >= 0 && sc >= 0;
      const T* src = valid ? img + ((long long)sr * a.W + sc) * a.C + c0 + cv * V : img;
      cp_async16(win + (long long)p * chunk + cv * V, src, valid);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  } else {
    for (int i = threadIdx.x; i < n_pix * chunk; i += blockDim.x) {
      const int p = i / chunk, c = i - p * chunk;
      const int u = p / win_cols;
      const int sr = src_row[u], sc = src_col[p - u * win_cols];
      win[i] = (sr >= 0 && sc >= 0) ? img[((long long)sr * a.W + sc) * a.C + c0 + c]
                                    : static_cast<T>(0.f);
    }
  }
  __syncthreads();
}

__device__ __forceinline__ float reduce(float v, int group) {
  switch (group) {
    case 4: return group_sum<4>(v);
    case 8: return group_sum<8>(v);
    case 16: return group_sum<16>(v);
    default: return group_sum<32>(v);
  }
}

template <typename T, int M>
__global__ void __launch_bounds__(kThreads, 2)
nfp_small_kernel(const T* __restrict__ x, float* __restrict__ out, Args a, int rows,
                 int chunk, int group) {
  extern __shared__ __align__(16) unsigned char smem[];
  Args am = a;
  am.measure = M;  // a constant: add_terms' and finish's switches fold
  Args ac = am;
  ac.C = chunk;    // for_channels walks one staged chunk

  const int k = 2 * a.radius + 1;
  const int n_nb = k * k - 1;
  const int centre = (k * k) / 2;  // row-major index of the centre tap
  const int span = (k - 1) * a.dilation;
  const int r = a.radius * a.dilation;
  const int n_tiles = (a.Ho + rows - 1) / rows;
  const int tile = blockIdx.x % n_tiles;
  const long long b = blockIdx.x / n_tiles;
  const int oh0 = tile * rows;
  const int tile_rows = min(rows, a.Ho - oh0);  // the last tile may be ragged
  const int win_rows = tile_rows + span, win_cols = a.Wo + span;
  const int n_pix = win_rows * win_cols;
  const int n_pairs = tile_rows * a.Wo * n_nb;
  const int n_chunks = a.C / chunk;

  const Layout L = smem_layout(a, rows, chunk, sizeof(T), M == PEARSON);
  T* win = reinterpret_cast<T*>(smem);
  float* means = reinterpret_cast<float*>(smem + L.means);
  float* acc = reinterpret_cast<float*>(smem + L.acc);
  float* vals = reinterpret_cast<float*>(smem + L.vals);
  int* src_row = reinterpret_cast<int*>(smem + L.index);
  int* src_col = src_row + win_rows;
  const T* img = x + b * a.H * a.W * a.C;

  for (int u = threadIdx.x; u < win_rows; u += blockDim.x)
    src_row[u] = src_index(oh0 + u - a.padding, a.H, a.pad_mode);
  for (int v = threadIdx.x; v < win_cols; v += blockDim.x)
    src_col[v] = src_index(v - a.padding, a.W, a.pad_mode);
  __syncthreads();

  const int lane = threadIdx.x & (group - 1);
  const int g = threadIdx.x / group, n_groups = blockDim.x / group;

  if constexpr (M == PEARSON) {  // each staged pixel's channel mean
    for (int ch = 0; ch < n_chunks; ++ch) {
      stage(win, img, src_row, src_col, a, n_pix, win_cols, ch * chunk, chunk);
      for (int p0 = 0; p0 < n_pix; p0 += n_groups) {
        const int p = p0 + g;
        float s = 0.f;
        if (p < n_pix) {
          const T* px = win + (long long)p * chunk;
          for_channels(px, px, ac, lane, group, [&](float c, float) { s += c; });
        }
        s = reduce(s, group);
        if (lane == 0 && p < n_pix) {
          if (ch > 0) s = means[p] + s;
          means[p] = ch + 1 < n_chunks ? s : s / a.C;
        }
      }
      __syncthreads();
    }
  }

  for (int ch = 0; ch < n_chunks; ++ch) {
    if (M != PEARSON || n_chunks > 1)  // pearson's one chunk is staged already
      stage(win, img, src_row, src_col, a, n_pix, win_cols, ch * chunk, chunk);
    for (int q0 = 0; q0 < n_pairs; q0 += n_groups) {
      const int q = q0 + g;
      float s0 = 0.f, s1 = 0.f, s2 = 0.f;
      if (q < n_pairs) {
        const int pos = q / n_nb, nb = q - pos * n_nb;
        const int lr = pos / a.Wo, ow = pos - lr * a.Wo;
        const int t = nb < centre ? nb : nb + 1;
        const int i = t / k, j = t - i * k;
        const int pc = (lr + r) * win_cols + ow + r;
        const int pn = (lr + i * a.dilation) * win_cols + ow + j * a.dilation;
        const T* xc = win + (long long)pc * chunk;
        const T* xn = win + (long long)pn * chunk;
        if constexpr (M == PEARSON) {
          const float mc = means[pc], mn = means[pn];
          for_channels(xc, xn, ac, lane, group, [&](float c, float n) {
            const float cc = c - mc, nc = n - mn;
            s0 += cc * nc; s1 += cc * cc; s2 += nc * nc;
          });
        } else {
          for_channels(xc, xn, ac, lane, group,
                       [&](float c, float n) { add_terms(am, c, n, s0, s1, s2); });
        }
      }
      s0 = reduce(s0, group);
      s1 = reduce(s1, group);
      s2 = reduce(s2, group);
      if (lane == 0 && q < n_pairs) {
        bool last = true;
        if (n_chunks > 1) {  // chunk sums added in chunk order
          float* aq = acc + 3 * q;
          if (ch > 0) { s0 = aq[0] + s0; s1 = aq[1] + s1; s2 = aq[2] + s2; }
          last = ch + 1 == n_chunks;
          if (!last) { aq[0] = s0; aq[1] = s1; aq[2] = s2; }
        }
        if (last) {
          const float v = apply_finalize(am, finish(am, s0, s1, s2));
          if (a.fuse_gap) vals[q] = v;
          else out[(b * a.Ho + oh0) * a.Wo * n_nb + q] = v;  // (B, H', W', N)
        }
      }
    }
    __syncthreads();
  }

  if (a.fuse_gap) {  // this tile's sum per neighbour, in position order
    const int n_pos = tile_rows * a.Wo;
    for (int nb = threadIdx.x; nb < n_nb; nb += blockDim.x) {
      float s = 0.f;
      for (int pos = 0; pos < n_pos; ++pos) s += vals[pos * n_nb + nb];
      vals[nb] = s;  // column nb of vals is this thread's alone
    }
    // the image's tiles are one cluster, the tile its block rank
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    if (tile == 0) {
      for (int nb = threadIdx.x; nb < n_nb; nb += blockDim.x) {
        float s = 0.f;
        for (int t = 0; t < n_tiles; ++t) s += *cluster.map_shared_rank(vals + nb, t);
        out[b * n_nb + nb] = s / (float)(a.Ho * a.Wo);
      }
    }
    cluster.sync();  // no block leaves while the first reads its shared memory
  }
}

template <typename T, int M>
int launch(const void* x, void* out, int batch, const Args& a, int rows, int chunk,
           int group, cudaStream_t stream) {
  const size_t smem = smem_layout(a, rows, chunk, sizeof(T), M == PEARSON).total;
  if (smem > (size_t)kMaxSmem || group < 4 || group > 32 || (group & (group - 1)) ||
      rows < 1 || chunk < 1 || a.C % chunk)
    return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    static const cudaError_t allowed = cudaFuncSetAttribute(
        nfp_small_kernel<T, M>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (allowed != cudaSuccess) return (int)allowed;
  }
  const int n_tiles = (a.Ho + rows - 1) / rows;
  if (n_tiles > 8) return (int)cudaErrorInvalidValue;  // a portable cluster
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = a.fuse_gap ? n_tiles : 1;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_tiles * batch);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, nfp_small_kernel<T, M>, static_cast<const T*>(x),
                                 static_cast<float*>(out), a, rows, chunk, group);
}

template <typename T>
int dispatch(const void* x, void* out, int batch, const Args& a, int rows, int chunk,
             int group, cudaStream_t s) {
#define K1_CASE(m) \
  case m: return launch<T, m>(x, out, batch, a, rows, chunk, group, s);
  switch (a.measure) {
    K1_CASE(NORM) K1_CASE(COSINE) K1_CASE(DOT) K1_CASE(RMSE) K1_CASE(GEMAN)
    K1_CASE(EMD) K1_CASE(CANBERRA) K1_CASE(HELLINGER) K1_CASE(CHISQ1)
    K1_CASE(CHISQ2) K1_CASE(GFC) K1_CASE(PEARSON) K1_CASE(JEFFREY)
    K1_CASE(SQUAREDCHORD) K1_CASE(SMITH) K1_CASE(SCS)
    default: return (int)cudaErrorInvalidValue;
  }
#undef K1_CASE
}

}  // namespace

extern "C" int nfp_small_forward(
    const void* x, void* out, int is_bf16, int batch, int H, int W,
    int C, int Ho, int Wo, int radius, int dilation, int padding, int pad_mode,
    int measure, int finalize, int similarity, int fuse_gap, int vec, float p,
    float eps, float q_scs, int rows, int chunk, int group, void* stream) {
  const Args a{H, W, C, Ho, Wo, radius, dilation, padding, pad_mode,
               measure, finalize, similarity, fuse_gap, vec, p, eps, q_scs};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch<__nv_bfloat16>(x, out, batch, a, rows, chunk, group, s);
  return dispatch<float>(x, out, batch, a, rows, chunk, group, s);
}
