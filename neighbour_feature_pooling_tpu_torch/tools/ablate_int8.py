"""Where the time of the int8 kernels K4 and K5 goes: each rebuilt with one
part cut out, and timed at the ResNet18 shapes of int8 serving.

    python -m neighbour_feature_pooling_tpu_torch.tools.ablate_int8 [--out FILE]

``csrc/int8_mma.cuh`` reads one macro, ``INT8K_ABLATE``: 1 writes the tile
with one store per thread, 2 leaves the ``wgmma`` instructions out, 3
fills the shared-memory ring without reading device memory. An ablated
kernel computes wrong values, so nothing is compared here: the tool only
says how much time each part costs where nothing else hides it. It also
times an empty kernel with the same timer (``common.median_ms``), the floor
under every kernel time the repo reports, and prints what ``ptxas -v``
says of each instantiation (registers, spills).
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess

import torch

from ..ops import _build
from ..ops.int8_conv import _library_fn as _conv_fn, int8_conv2d, pack_conv_weight
from ..ops.int8_gemm import _library_fn as _gemm_fn, int8_gemm, pack_weight
from .common import OUT_DIR, append_record, card, median_ms

VARIANTS = {"full": 0, "one_store": 1, "no_mma": 2, "no_loads": 3}  # no_mma: no wgmma
RUNS = 50

#: (label, x shape, (kh, kw, cout), padding, strides): K5 at B=32
CONV_CASES = [
    ("stem 7x7/2", (32, 224, 224, 3), (7, 7, 64), ((3, 3), (3, 3)), (2, 2)),
    ("layer1 3x3", (32, 56, 56, 64), (3, 3, 64), ((1, 1), (1, 1)), (1, 1)),
    ("layer3 3x3", (32, 14, 14, 256), (3, 3, 256), ((1, 1), (1, 1)), (1, 1)),
    ("layer4 3x3", (32, 7, 7, 512), (3, 3, 512), ((1, 1), (1, 1)), (1, 1)),
]
#: (label, M, K, N): K4 at B=32
GEMM_CASES = [("layer2 downsample", 25088, 64, 128), ("layer4 downsample", 1568, 256, 512)]

EMPTY_CU = """
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
"""


def empty_kernel_ms() -> float:
    """The timer's floor: the time ``median_ms`` reads for an empty kernel."""
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    src, lib = (os.path.join(_build.BUILD_DIR, f"empty_kernel.{ext}") for ext in ("cu", "so"))
    with open(src, "w") as f:
        f.write(EMPTY_CU)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib, src], check=True,
                   capture_output=True, text=True)
    fn = ctypes.CDLL(lib).empty_launch
    fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int
    return median_ms(lambda: fn(torch.cuda.current_stream().cuda_stream), RUNS, warmup=3)


def rebuild(define: int) -> dict:
    """Build and load K4 and K5 with ``-DINT8K_ABLATE=define``; returns the
    compiler's output per kernel."""
    _build.NVCC_FLAGS[:] = [f for f in _build.NVCC_FLAGS if not f.startswith("-DINT8K_ABLATE")]
    _build.NVCC_FLAGS.append(f"-DINT8K_ABLATE={define}")
    for name in ("int8_gemm", "int8_conv"):
        _build._loaded.pop(name, None)
    _gemm_fn.cache_clear()
    _conv_fn.cache_clear()
    return _build.build_all(["int8_gemm", "int8_conv"])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(OUT_DIR, "ablate_int8.jsonl"))
    args = ap.parse_args()
    where = card("cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)

    def s8(shape):
        return torch.randint(-127, 128, shape, generator=gen, device="cuda", dtype=torch.int8)

    def affine(n):
        return dict(scale=torch.rand(n, generator=gen, device="cuda") * 5e-3 + 1e-4,
                    bias=torch.rand(n, generator=gen, device="cuda") * 4 - 2)

    calls = {}
    for label, xshape, (kh, kw, cout), padding, strides in CONV_CASES:
        x, w = s8(xshape), s8((kh, kw, xshape[3], cout))
        kwargs = dict(affine(cout), padding=padding, strides=strides,
                      w_packed=pack_conv_weight(w))
        calls[f"K5 {label}"] = lambda x=x, w=w, kwargs=kwargs: int8_conv2d(x, w, **kwargs)
    for label, m, k, n in GEMM_CASES:
        a, b = s8((m, k)), s8((k, n))
        kwargs = dict(affine(n), b_packed=pack_weight(b))
        calls[f"K4 {label}"] = lambda a=a, b=b, kwargs=kwargs: int8_gemm(a, b, **kwargs)

    append_record(args.out, dict(where, what="empty kernel", ms=empty_kernel_ms()))
    for variant, define in VARIANTS.items():
        logs = rebuild(define)
        if variant == "full":
            for kernel, log in logs.items():
                for line in log.splitlines():
                    if "registers" in line or "spill" in line or "Compiling entry" in line:
                        print(f"  {kernel}: {line.strip()}")
        for label, call in calls.items():
            append_record(args.out, dict(where, what=label, variant=variant,
                                         ms=median_ms(call, RUNS, warmup=3)))


if __name__ == "__main__":
    main()
