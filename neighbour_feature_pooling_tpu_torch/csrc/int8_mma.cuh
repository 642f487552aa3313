// The block tile shared by the int8 kernels int8_gemm.cu (K4) and
// int8_conv.cu (K5): C[M, N] = A[M, K] x B[K, N] in s8 x s8 -> s32 on the
// tensor cores (wgmma m64n64k32, both operands from shared memory), then
// the dequant epilogue of int8_epilogue.cuh.
//
// A is never materialised: each kernel passes a gather that maps (row m,
// column k) to a byte of its input, or to a zero. K4's gather reads a
// row-major (M, K) matrix; K5's reads the NHWC image at the tap (dy, dx) and
// channel ci of column k = (dy * kw + dx) * Cin + ci for the output position
// of row m, with the stride and the zero padding in its index math. B is
// the weight, packed once on the host (ops/int8_gemm.py::pack_weight) as
// (N, Kp): k contiguous, Kp = K rounded up to 16 and zero filled. So both
// operands reach shared memory as 16-byte runs of k, K-major, the only
// form wgmma takes for s8. Nothing is transposed in the kernel.
//
// Tiling: a block owns a BM x 64 tile of C, BM = 128 or 64 (the wrapper
// picks 64 when the 128-row grid would leave SMs idle), and walks K in
// steps of 64 bytes. One warpgroup (128 threads) per 64 rows of the tile:
// it issues two wgmma m64n64k32 per step and keeps its 64 x 64 s32 part in
// 32 registers a thread. All threads share the loads.
//
// Global -> shared: a ring of four stages filled by cp.async, three steps
// ahead of the tensor cores. Per step: cp.async.wait_group, a
// fence.proxy.async (wgmma reads shared memory through the async proxy,
// cp.async and st.shared wrote it through the generic one), one
// __syncthreads, the step's wgmmas as one group, wgmma.wait_group 1 (the
// previous step's group is done, so its stage is free), then the loads of
// three steps ahead, which run while the tensor cores work. The gather's
// verdict (inside the image, row < M, k < K) is cp.async's source size: 0
// reads nothing and zero-fills. A moves as 16-byte chunks when 16
// consecutive k are contiguous in memory (Cin % 16 == 0; K % 16 == 0 for a
// GEMM), as 4-byte words when 4 are (Cin % 4 == 0: the RGB stem, padded to
// 4 channels by the wrapper), else byte by byte through registers into the
// same layout (ragged K or Cin; no main-path shape). A thread keeps its
// column's tap and steps it by additions: no division in the loop.
//
// Shared layout: rows of 64 bytes of k; the 16-byte chunk c of row r sits at
// chunk c ^ ((r >> 1) & 3): wgmma's 64-byte swizzle (address bits 4-5 xor
// bits 7-8; each stage starts on a multiple of 512 bytes), under which the
// 8 chunks of a cp.async phase fall in 8 different 16-byte bank groups. A
// descriptor names a stage's rows (8-row groups 512 bytes apart) and its
// first or second 32 bytes of k.
//
// Epilogue: after the K loop the ring is free. Each thread puts its results
// through dequant, in the output type, into a BM x 64 staging tile there
// (the tile's scale and bias wait in shared memory since the block began);
// then the block writes each output row as 16-byte stores, neighbouring
// threads on neighbouring addresses (element by element on a ragged-N edge
// or when N * element size is not a multiple of 16). Ragged M, N and K are
// masked in the loads and the stores; nothing is padded on the host but the
// weight's k.
//
// What holds it back now (tools/ablate_int8.py on an H100): at the deep
// ResNet18 stages neither the wgmmas, nor the global loads, nor the stores
// carry the time: a step costs ~400 cycles of issue and synchronisation
// latency, and grids of 200-400 blocks give an SM one to three blocks to
// hide it with. A split over K would give it more.
//
// INT8K_ABLATE (tools/ablate_int8.py) cuts one part out to time the rest:
// 1 = one store per thread, 2 = no wgmma, 3 = no global loads.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "int8_epilogue.cuh"

#ifndef INT8K_ABLATE
#define INT8K_ABLATE 0
#endif

namespace int8k {

constexpr int BN = 64;       // columns of a tile
constexpr int BK = 64;       // bytes of k per step: one shared-memory row
constexpr int kStages = 4;   // a power of two

// How A reaches shared memory; keep in sync with ops/int8_gemm.py::a_mode.
enum AMode { A_BYTES = 0, A_WORDS = 1, A_CHUNKS = 2 };

// The gather's view of one row of A (one output position for K5).
struct Row {
  long long base;
  int iy0, ix0;
};

template <int BM>
struct Tile {
  static constexpr int kA = BM * BK;  // bytes of one stage of A
  static constexpr int kB = BN * BK;
  static constexpr int kRing = kStages * (kA + kB);
  static constexpr int kAffine = kRing + BM * (int)sizeof(Row);  // scale, bias
  static constexpr int kSmem = kAffine + 2 * BN * (int)sizeof(float);
  // a warpgroup (128 threads) per 64 rows of the tile
  static constexpr int kThreads = 2 * BM;
  // the fewest blocks an SM should hold, which caps the registers at 128 a
  // thread (ptxas takes 58-97); 4 x 52 KB or 6 x 35 KB fit its shared memory
  static constexpr int kMinBlocks = BM == 128 ? 2 : 4;
};

// Byte offset of 16-byte chunk c of row r in a stage.
__device__ __forceinline__ int swizzled(int r, int c) {
  return r * BK + (((c ^ (r >> 1)) & 3) << 4);
}

// The shared-memory descriptor of a K-major operand tile in this layout:
// rows of 64 bytes under the 64-byte swizzle, 8-row groups 512 bytes apart.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | (32ull << 32) |
         (2ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d (64 x 64 s32 over the warpgroup) += A (64 rows x 32 bytes of k) x
// B (64 columns x 32 bytes of k), both from shared memory.
__device__ __forceinline__ void wgmma_m64n64k32(int* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, %32, %33, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]),
        "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]),
        "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),
        "+r"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

// N bytes from src to shared memory when ok, else N zeros and no read.
template <int N>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         bool ok) {
  const int n = ok && INT8K_ABLATE != 3 ? N : 0;
  if (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(n)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
                 "l"(src), "r"(n)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One step of A, rows [0, BM) x k [k0, k0 + BK), into the stage at `stage`
// (generic pointer) / `stage_u32` (shared-space address). `tap` is this
// thread's column of the step for the two cp.async modes, and moves on to
// the next step here.
template <class G, int BM, int AMODE>
__device__ __forceinline__ void load_a(const G& g, const int8_t* __restrict__ A,
                                       const Row* rows, typename G::Tap& tap,
                                       int k0, unsigned char* stage,
                                       uint32_t stage_u32) {
  const int tid = threadIdx.x;
  if (AMODE == A_CHUNKS) {
    // chunk tid + 2 BM i: row tid / 4 + BM / 2 i, bytes 16 (tid % 4) of the step
    const int c = tid & 3;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = (tid >> 2) + BM / 2 * i;
      long long off;
      const bool ok = g.at(rows[r], tap, off);
      cp_async<16>(stage_u32 + swizzled(r, c), A + (ok ? off : 0), ok);
    }
    g.advance(tap);
  } else {
    // word tid + 2 BM i: row tid / 16 + BM / 8 i, bytes 4 (tid % 16) of the step
    const int wd = tid & 15;
    typename G::Tap t[4];
    if (AMODE == A_BYTES) {
#pragma unroll
      for (int j = 0; j < 4; ++j) t[j] = g.tap(k0 + wd * 4 + j);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = (tid >> 4) + BM / 8 * i;
      const int dst = swizzled(r, wd >> 2) + (wd & 3) * 4;
      const Row row = rows[r];
      long long off;
      if (AMODE == A_WORDS) {
        const bool ok = g.at(row, tap, off);
        cp_async<4>(stage_u32 + dst, A + (ok ? off : 0), ok);
      } else {
        uint32_t w = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (g.at(row, t[j], off) && INT8K_ABLATE != 3)
            w |= (uint32_t)(uint8_t)A[off] << (8 * j);
        *reinterpret_cast<uint32_t*>(stage + dst) = w;
      }
    }
    if (AMODE == A_WORDS) g.advance(tap);
  }
}

// This thread's part of the packed B: chunk tid % 4 of rows n0 + tid / 4 +
// kThreads / 4 i of every step, with the addresses that do not change from
// step to step.
template <int kThreads>
struct BLoader {
  static constexpr int kRows = BN * 4 / kThreads;
  const int8_t* src[kRows];  // the chunk at k0 = 0, or null for a row past N
  int dst[kRows];
  int k, Kp;

  __device__ BLoader(const int8_t* __restrict__ Bp, int N, int Kp, int n0)
      : k((threadIdx.x & 3) * 16), Kp(Kp) {
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = (threadIdx.x >> 2) + kThreads / 4 * i;
      src[i] = n0 + r < N ? Bp + (long long)(n0 + r) * Kp + k : nullptr;
      dst[i] = swizzled(r, threadIdx.x & 3);
    }
  }

  // Rows n [n0, n0 + BN) x k [k0, k0 + BK) into the stage at stage_u32.
  __device__ __forceinline__ void load(const int8_t* __restrict__ Bp, int k0,
                                       uint32_t stage_u32) const {
    const bool in_k = k0 + k < Kp;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const bool ok = in_k && src[i] != nullptr;
      cp_async<16>(stage_u32 + dst[i], ok ? src[i] + k0 : Bp, ok);
    }
  }
};

template <int KIND>
struct OutElem {
  static constexpr int kSize = KIND == OUT_S8 ? 1 : 4;
  // row pitch of the staging tile: the 8-byte (2-byte for s8) stores of a
  // warp, 8 rows at a time, then fall in different banks
  static constexpr int kPitch = BN * kSize + (KIND == OUT_S8 ? 16 : 32);
};

// The tile's results through the epilogue into the staging tile at smem, then
// out to device memory row by row.
template <int BM, int KIND>
__device__ __forceinline__ void write_tile(const int (&acc)[32],
                                           const Epilogue& e, void* out, int M,
                                           int N, unsigned char* smem,
                                           const float* affine) {
  constexpr int ES = OutElem<KIND>::kSize, kPitch = OutElem<KIND>::kPitch;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;  // accumulator coordinates
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const bool has_bias = e.bias != nullptr, relu = e.relu != 0;

  // accumulator 4 j + c of the warp: row 16 warp + gq (+8 for c >= 2), column
  // 8 j + 2 tq + c % 2 (a warpgroup's four warps cover its 64 rows)
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = j * 8 + tq * 2;
    float2 scale = make_float2(0.f, 0.f), bias = scale;
    if (KIND != OUT_S32) {
      scale = *reinterpret_cast<const float2*>(affine + col);
      bias = *reinterpret_cast<const float2*>(affine + BN + col);
    }
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const int a0 = acc[4 * j + 2 * v], a1 = acc[4 * j + 2 * v + 1];
      unsigned char* p = smem + (warp * 16 + gq + 8 * v) * kPitch + col * ES;
      if (KIND == OUT_S32) {
        *reinterpret_cast<int2*>(p) = make_int2(a0, a1);
      } else {
        const float y0 = dequant(a0, scale.x, bias.x, has_bias, relu);
        const float y1 = dequant(a1, scale.y, bias.y, has_bias, relu);
        if (KIND == OUT_F32)
          *reinterpret_cast<float2*>(p) = make_float2(y0, y1);
        else
          *reinterpret_cast<char2*>(p) = make_char2(requant(y0), requant(y1));
      }
    }
  }
  __syncthreads();

  constexpr int kChunks = BN * ES / 16;        // 16-byte chunks of a row
  constexpr int kRows = Tile<BM>::kThreads / kChunks;  // rows written per pass
  constexpr int kElems = 16 / ES;              // elements of a chunk
  const int c = tid % kChunks;
  const int n = n0 + c * kElems;
  const bool wide = ((long long)N * ES) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
#pragma unroll
  for (int i = 0; i < (INT8K_ABLATE == 1 ? 1 : BM / kRows); ++i) {
    const int r = tid / kChunks + i * kRows;
    const int m = m0 + r;
    if (m >= M || n >= N) continue;
    const unsigned char* s = smem + r * kPitch + c * 16;
    unsigned char* d = static_cast<unsigned char*>(out) + ((long long)m * N + n) * ES;
    if (wide && n + kElems <= N) {
      *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(s);
    } else {
      for (int q = 0; q < kElems && n + q < N; ++q) {
        if (ES == 4)
          reinterpret_cast<uint32_t*>(d)[q] = reinterpret_cast<const uint32_t*>(s)[q];
        else
          d[q] = s[q];
      }
    }
  }
}

// One block's BM x BN tile of C; blockIdx.x walks M, blockIdx.y walks N.
// smem: Tile<BM>::kSmem bytes of dynamic shared memory, 1024-byte aligned.
template <class G, int BM, int AMODE>
__device__ __forceinline__ void mma_tile(const G& g,
                                         const int8_t* __restrict__ A,
                                         const int8_t* __restrict__ Bp, int M,
                                         int N, int K, int Kp,
                                         const Epilogue& e, void* out,
                                         unsigned char* smem) {
  using T = Tile<BM>;
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;

  Row* rows = reinterpret_cast<Row*>(smem + T::kRing);
  if (tid < BM) rows[tid] = g.row(m0 + tid);
  // the tile's scale and bias, read by write_tile long after
  float* affine = reinterpret_cast<float*>(smem + T::kAffine);
  if (tid < BN && e.kind != OUT_S32) {
    const bool in_n = n0 + tid < N;
    affine[tid] = in_n ? e.scale[n0 + tid] : 0.f;
    affine[BN + tid] = in_n && e.bias != nullptr ? e.bias[n0 + tid] : 0.f;
  }
  __syncthreads();

  int acc[32];  // this warpgroup's 64 x 64 part of the tile: rows 64 (tid / 128)
#pragma unroll
  for (int c = 0; c < 32; ++c) acc[c] = 0;

  const uint32_t ring_a = (uint32_t)__cvta_generic_to_shared(smem);
  const uint32_t ring_b = ring_a + kStages * T::kA;
  typename G::Tap tap =
      g.tap(AMODE == A_CHUNKS ? (tid & 3) * 16 : (tid & 15) * 4);

  const BLoader<T::kThreads> b(Bp, N, Kp, n0);

  auto load_step = [&](int t) {
    const int slot = t & (kStages - 1);
    load_a<G, BM, AMODE>(g, A, rows, tap, t * BK, smem + slot * T::kA,
                         ring_a + slot * T::kA);
    b.load(Bp, t * BK, ring_b + slot * T::kB);
  };

  const int k_steps = (K + BK - 1) / BK;
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < k_steps) load_step(t);
    cp_async_commit();  // a group per step, empty past the end
  }

  for (int s = 0; s < k_steps; ++s) {
    cp_async_wait<kStages - 2>();  // step s has landed (this thread's part)
    // what cp.async and st.shared wrote, made visible to the async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // ... and everyone's
    const int slot = s & (kStages - 1);
    const uint32_t sa = ring_a + slot * T::kA + (tid >> 7) * 64 * BK;
    const uint32_t sb = ring_b + slot * T::kB;
    if (INT8K_ABLATE != 2) {
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < BK / 32; ++ks)
        wgmma_m64n64k32(acc, wgmma_desc(sa + ks * 32), wgmma_desc(sb + ks * 32));
      wgmma_commit();
    }
    // step s - 1 has been read by the tensor cores: its slot takes step s + 3
    // while they work on step s
    if (INT8K_ABLATE != 2) wgmma_wait<1>();
    if (s + kStages - 1 < k_steps) load_step(s + kStages - 1);
    cp_async_commit();
  }
  if (INT8K_ABLATE != 2) wgmma_wait<0>();
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: the staging tile takes its place

  switch (e.kind) {
    case OUT_S32: write_tile<BM, OUT_S32>(acc, e, out, M, N, smem, affine); break;
    case OUT_F32: write_tile<BM, OUT_F32>(acc, e, out, M, N, smem, affine); break;
    default: write_tile<BM, OUT_S8>(acc, e, out, M, N, smem, affine); break;
  }
}

constexpr int kMaxDevices = 64;

// Launch kernel (a __global__ over mma_tile<G, BM, AMODE>) on its grid;
// returns the cudaError_t. ready[device] says that this kernel may already
// take its dynamic shared memory there: the attribute is set once, not at
// every launch.
template <int BM, class Kernel, class... Args>
int launch_tile(Kernel kernel, bool* ready, int M, int N, cudaStream_t stream,
                Args... args) {
  int device = 0;
  cudaError_t rc = cudaGetDevice(&device);
  if (rc != cudaSuccess) return (int)rc;
  if (device >= kMaxDevices || !ready[device]) {
    rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              Tile<BM>::kSmem);
    if (rc != cudaSuccess) return (int)rc;
    if (device < kMaxDevices) ready[device] = true;
  }
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  kernel<<<grid, Tile<BM>::kThreads, Tile<BM>::kSmem, stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace int8k
