"""Texture pooling ops (counterpart of ``neighbour_feature_pooling_tpu.ops``).

Ported so far: ``nfp`` — Neighborhood Feature Pooling, with the small-map
and large-map CUDA kernels (``nfp_cuda.py``) and their plain PyTorch
version (``neighborhood.nfp_reference``); ``nfp_kernel``, the direct kernel
entry (the JAX ``nfp_pallas``), which also reaches the strip kernel K3;
the int8 GEMM and conv of the
int8 serving tier (``int8_gemm.py``, ``int8_conv.py``) with their plain
versions and the shared ``common.dequant_epilogue``; the other texture ops,
XLA ops in the JAX package and stock PyTorch ops here: ``fractal``,
``lacunarity``, ``deepten`` and ``radam``.
"""

from .common import dequant_epilogue, safe_sqrt  # noqa: F401
from .deepten import deepten_encode, deepten_init  # noqa: F401
from .fractal import gdcb_fractal_dim  # noqa: F401
from .int8_conv import int8_conv2d, int8_conv2d_reference  # noqa: F401
from .int8_gemm import int8_gemm, int8_gemm_reference  # noqa: F401
from .lacunarity import base_lacunarity  # noqa: F401
from .measures import (  # noqa: F401
    MEASURES,
    MEASURE_NAMES,
    Measure,
    MeasureConfig,
    SEPARABLE,
    canonical_measure_name,
    get_measure,
    get_separable,
)
from .neighborhood import (  # noqa: F401
    neighbor_offsets,
    nfp_output_size,
    nfp_reference,
    num_neighbors,
    pad_spatial,
)
from .nfp_cuda import (  # noqa: F401
    nfp,
    nfp_kernel,
    nfp_large_cuda,
    nfp_small_cuda,
    nfp_strip_cuda,
)
from .radam import radam_pool  # noqa: F401
