"""Texture pooling ops (counterpart of ``neighbour_feature_pooling_tpu.ops``).

Ported so far: ``nfp`` — Neighborhood Feature Pooling, with the small-map
and large-map CUDA kernels (``nfp_cuda.py``) and their plain PyTorch
version (``neighborhood.nfp_reference``).
"""

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
from .nfp_cuda import nfp, nfp_large_cuda, nfp_small_cuda  # noqa: F401
