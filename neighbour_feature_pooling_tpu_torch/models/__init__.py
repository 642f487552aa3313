"""Model zoo: PyTorch backbones × texture-pooling heads."""

from . import backbones, heads  # noqa: F401
from .from_jax import state_dict_from_flax, torch_module_name  # noqa: F401
from .zoo import (  # noqa: F401
    MODEL_VARIANTS,
    NUM_FTRS,
    TextureModel,
    canonical_model_type,
    check_ported,
    get_model,
    init_params,
)
