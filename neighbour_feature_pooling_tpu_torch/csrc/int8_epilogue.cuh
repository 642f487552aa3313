// Dequant epilogue of the int8 kernels int8_gemm.cu (K4) and int8_conv.cu
// (K5): the counterpart of neighbour_feature_pooling_tpu/ops/common.py::
// dequant_epilogue and of the port's ops/common.py::dequant_epilogue.
//
//   y = acc * scale[n] + bias[n]      (two fp32 ops, each rounded on its own)
//   y = max(y, 0)                      (relu)
//   q = clamp(rint(y), -127, 127)      (s8 output only; half to even)
//
// Two hazards decide how it is written:
//  * nvcc contracts `a * b + c` into one fma by default, which rounds once
//    where XLA and the plain PyTorch version round twice: an fp32 output
//    would differ by an ulp, and an s8 one by a step at every .5 tie, which
//    chained layers carry on. __fmul_rn / __fadd_rn are never contracted.
//  * rintf rounds half to even, as jnp.round and torch.round do; roundf
//    would round half away from zero.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace int8k {

enum OutKind { OUT_S32 = 0, OUT_F32 = 1, OUT_S8 = 2 };

struct Epilogue {
  const float* scale;  // per output column; unused for OUT_S32
  const float* bias;   // per output column, or null
  int kind;            // OutKind
  int relu;
};

// bias and relu are the block's copies of e.bias != nullptr and e.relu,
// read once: the tile's 64 values a thread share them.
__device__ __forceinline__ float dequant(int acc, float scale, float bias,
                                         bool has_bias, bool relu) {
  float y = __fmul_rn(__int2float_rn(acc), scale);
  if (has_bias) y = __fadd_rn(y, bias);
  if (relu) y = fmaxf(y, 0.f);
  return y;
}

__device__ __forceinline__ int8_t requant(float y) {
  return (int8_t)__float2int_rn(fminf(fmaxf(rintf(y), -127.f), 127.f));
}

}  // namespace int8k
