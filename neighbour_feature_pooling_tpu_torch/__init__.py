"""PyTorch/CUDA port of ``neighbour_feature_pooling_tpu``.

The JAX package beside this one is the reference; module paths and names
here mirror it so each counterpart is easy to find. Plain tensor work is
PyTorch (fp32 convs, BatchNorm, matmuls stay cuDNN/cuBLAS, as the JAX package
left them to XLA); every Pallas TPU kernel on a ported path is a CUDA
kernel written by hand for Hopper (``csrc/``), built at first use.

Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``; on the CPU each kernel wrapper takes its plain PyTorch
version. This package imports neither JAX nor the JAX package.

Ported so far: the serving path (``serve.Predictor``) of ResNet18 ×
{``gap_only``, ``texture_nfp``} and MobileNetV3-Large × {``gap_only``,
``texture_nfp``, ``texture_nfp_intermediate``, ``mid_nfp``,
``multi_stage_nfp``, ``nfp_insert``}, with the small-map and large-map
NFP kernels; and int8 serving (``quant.py``, ``Predictor(quantize="int8")``)
with the int8 GEMM and conv kernels; and training on one device
(``train/``, ``data/``, ``cli.py``: ``python -m
neighbour_feature_pooling_tpu_torch.cli``), where ``ops.nfp`` runs its
kernel forward and differentiates the plain version backward. See
``ROADMAP.md`` for what is still to come.
"""

__version__ = "0.1.0"
