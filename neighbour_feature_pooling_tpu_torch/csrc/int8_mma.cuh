// The block tile shared by the int8 kernels int8_gemm.cu (K4) and
// int8_conv.cu (K5): C[M, N] = A[M, K] x B[K, N] in s8 x s8 -> s32 on the
// tensor cores (mma.sync m16n8k32), then the dequant epilogue of
// int8_epilogue.cuh.
//
// A is never materialised: each kernel passes a gather that maps (row m,
// column k) to a byte of its input, or to a zero. K4's gather reads a
// row-major (M, K) matrix; K5's reads the NHWC image at the tap (dy, dx) and
// channel ci of column k = (dy * kw + dx) * Cin + ci for the output position
// of row m, with the stride and the zero padding in its index math. B is
// the (K, N) weight, row-major (HWIO for a conv): both kernels read it alike.
//
// Tiling: a block owns a BM x BN tile of C and walks K in steps of BK bytes.
// Each step stages A (BM x BK) and B (BN x BK, transposed so that k is
// contiguous, as mma.sync's "col" B operand wants) in shared memory, with
// rows padded to 80 bytes so that the fragment loads of a warp fall in 32
// different banks. Two buffers: the global loads of step t+1 are in flight
// in registers while the tensor cores work on step t. Four warps, 2 x 2,
// each own a 64 x 32 tile: 4 x 4 mma.sync per 32 bytes of K, 64 s32
// accumulators a thread. Ragged M, N and K are masked in the loads and the
// stores; nothing is padded on the host.
//
// A column step of A is read as 16-byte chunks when the gather guarantees
// that 16 consecutive k lie in one contiguous run (VEC: Cin % 16 == 0 for a
// conv, K % 16 == 0 for a GEMM, 16-byte aligned base), else byte by byte
// in words of 4 (the RGB stem, Cin = 3). B is read as 4 x 4 byte blocks of
// 32-bit rows, transposed in registers with __byte_perm, when N % 4 == 0;
// else byte by byte.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "int8_epilogue.cuh"

namespace int8k {

constexpr int BM = 128;
constexpr int BN = 64;
constexpr int BK = 64;
constexpr int kThreads = 128;
constexpr int kPitch = BK + 16;  // bytes per shared-memory row

// The gather's view of one row of A (one output position for K5).
struct Row {
  long long base;
  int iy0, ix0;
};

struct Smem {
  int8_t a[2][BM * kPitch];
  int8_t b[2][BN * kPitch];
  Row rows[BM];
};

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a,
                                       const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Registers that carry one K step from global to shared memory.
struct Stage {
  uint4 a_vec[4];    // VEC: four 16-byte chunks of A
  uint32_t a_w[16];  // else: sixteen 4-byte words of A
  uint32_t b[8];     // two 4 x 4 blocks of B, transposed
};

template <class G, bool VEC>
__device__ __forceinline__ void load_a(const G& g, const int8_t* __restrict__ A,
                                       const Smem& sm, int k0, Stage& st) {
  const int tid = threadIdx.x;
  if (VEC) {
    // chunk c = tid + 128 i: row c / 4, bytes 16 (c % 4) of the step
    const typename G::Tap t = g.tap(k0 + (tid & 3) * 16);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      long long off;
      st.a_vec[i] = g.at(sm.rows[(tid >> 2) + 32 * i], t, off)
                        ? *reinterpret_cast<const uint4*>(A + off)
                        : make_uint4(0u, 0u, 0u, 0u);
    }
  } else {
    // word w = tid + 128 i: row w / 16, bytes 4 (w % 16) of the step
    typename G::Tap t[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) t[j] = g.tap(k0 + (tid & 15) * 4 + j);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const Row r = sm.rows[(tid >> 4) + 8 * i];
      uint32_t w = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        long long off;
        if (g.at(r, t[j], off)) w |= (uint32_t)(uint8_t)A[off] << (8 * j);
      }
      st.a_w[i] = w;
    }
  }
}

__device__ __forceinline__ void load_b(const int8_t* __restrict__ B, int N,
                                       int K, int n0, int k0, bool vec_b,
                                       Stage& st) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    // 4 x 4 block q = tid + 128 i: k quad q / 16, n quad q % 16
    const int q = tid + kThreads * i;
    const int k = k0 + (q >> 4) * 4;
    const int n = n0 + (q & 15) * 4;
    uint32_t r[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      r[j] = 0;
      if (k + j >= K) continue;
      const int8_t* p = B + (long long)(k + j) * N + n;
      if (vec_b && n + 3 < N) {
        r[j] = *reinterpret_cast<const uint32_t*>(p);
      } else {
        for (int c = 0; c < 4; ++c)
          if (n + c < N) r[j] |= (uint32_t)(uint8_t)p[c] << (8 * c);
      }
    }
    // row j holds B[k + j][n .. n + 3]; column c of the block becomes the
    // word (B[k][n + c], B[k + 1][n + c], B[k + 2][n + c], B[k + 3][n + c])
    const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);
    const uint32_t t1 = __byte_perm(r[2], r[3], 0x5140);
    const uint32_t t2 = __byte_perm(r[0], r[1], 0x7362);
    const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
    st.b[4 * i + 0] = __byte_perm(t0, t1, 0x5410);
    st.b[4 * i + 1] = __byte_perm(t0, t1, 0x7632);
    st.b[4 * i + 2] = __byte_perm(t2, t3, 0x5410);
    st.b[4 * i + 3] = __byte_perm(t2, t3, 0x7632);
  }
}

template <bool VEC>
__device__ __forceinline__ void store_stage(const Stage& st, int8_t* sa,
                                            int8_t* sb) {
  const int tid = threadIdx.x;
  if (VEC) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<uint4*>(sa + ((tid >> 2) + 32 * i) * kPitch +
                                (tid & 3) * 16) = st.a_vec[i];
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i)
      *reinterpret_cast<uint32_t*>(sa + ((tid >> 4) + 8 * i) * kPitch +
                                   (tid & 15) * 4) = st.a_w[i];
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int q = tid + kThreads * i;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      *reinterpret_cast<uint32_t*>(sb + ((q & 15) * 4 + c) * kPitch +
                                   (q >> 4) * 4) = st.b[4 * i + c];
  }
}

// One block's BM x BN tile of C; blockIdx.x walks M, blockIdx.y walks N.
template <class G, bool VEC>
__device__ __forceinline__ void mma_tile(const G& g,
                                         const int8_t* __restrict__ A,
                                         const int8_t* __restrict__ B, int M,
                                         int N, int K, bool vec_b,
                                         const Epilogue& e, void* out,
                                         Smem& sm) {
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;  // mma fragment coordinates
  const int wm = (warp >> 1) * 64, wn = (warp & 1) * 32;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;

  sm.rows[tid] = g.row(m0 + tid);  // BM == kThreads
  __syncthreads();

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0;

  const int k_steps = (K + BK - 1) / BK;
  Stage st;
  load_a<G, VEC>(g, A, sm, 0, st);
  load_b(B, N, K, n0, 0, vec_b, st);
  store_stage<VEC>(st, sm.a[0], sm.b[0]);
  __syncthreads();

  for (int s = 0; s < k_steps; ++s) {
    const int buf = s & 1;
    const bool more = s + 1 < k_steps;
    if (more) {  // in flight while the tensor cores work on step s
      load_a<G, VEC>(g, A, sm, (s + 1) * BK, st);
      load_b(B, N, K, n0, (s + 1) * BK, vec_b, st);
    }
    const int8_t* sa = sm.a[buf];
    const int8_t* sb = sm.b[buf];
#pragma unroll
    for (int ks = 0; ks < BK; ks += 32) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int8_t* p = sa + (wm + i * 16 + gq) * kPitch + ks + tq * 4;
        af[i][0] = *reinterpret_cast<const uint32_t*>(p);
        af[i][1] = *reinterpret_cast<const uint32_t*>(p + 8 * kPitch);
        af[i][2] = *reinterpret_cast<const uint32_t*>(p + 16);
        af[i][3] = *reinterpret_cast<const uint32_t*>(p + 8 * kPitch + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int8_t* p = sb + (wn + j * 8 + gq) * kPitch + ks + tq * 4;
        bf[j][0] = *reinterpret_cast<const uint32_t*>(p);
        bf[j][1] = *reinterpret_cast<const uint32_t*>(p + 16);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], af[i], bf[j]);
    }
    if (more) store_stage<VEC>(st, sm.a[buf ^ 1], sm.b[buf ^ 1]);
    __syncthreads();
  }

  // accumulator c of tile (i, j): row gq (+8 for c >= 2), column 2 tq + c % 2
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + wn + j * 8 + tq * 2 + h;
      if (n >= N) continue;
      const float scale = e.kind == OUT_S32 ? 0.f : e.scale[n];
      const float bias = e.bias != nullptr ? e.bias[n] : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          const int m = m0 + wm + i * 16 + gq + 8 * v;
          if (m < M)
            store_out(e, out, (long long)m * N + n, acc[i][j][2 * v + h],
                      scale, bias);
        }
      }
    }
  }
}

}  // namespace int8k
