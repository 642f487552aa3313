"""Card tools of the port, run as ``python -m neighbour_feature_pooling_tpu_torch.tools.<name>``.

* ``bench_nfp_kernel``: the direct kernel entry ``ops.nfp_kernel`` against
  the plain version at the large-map shapes, times on the card (CUDA events).
* ``sweep_nfp_kernel``: ``nfp_kernel`` against the plain version over the
  geometry corners (R=2, dilation, bf16, odd widths, fused GAP) and the
  three kernels' routes.

Both append JSON lines to ``--out`` (under the git-ignored ``logs/`` by
default) and run on the card unless ``--device cpu`` is given.
"""
