"""The direct NFP kernel entry over the geometry corners, against the plain version.

    python -m neighbour_feature_pooling_tpu_torch.tools.sweep_nfp_kernel [--configs pearson_gap_r2]

Counterpart of the JAX package's ``scripts/sweep_nfp_kernel.py``: its ten
configurations (R=2, dilation 2, bf16, odd widths, fused GAP; small maps
reach K1, large ones K2) and four more with ``pearson`` on large maps,
which reach K3, a body the JAX list never reaches. Each goes once through
``ops.nfp_kernel`` (on the card, checked to have launched its route's
kernel once) and is compared with ``nfp_reference`` run in fp32 on the same
values and rounded once to the input dtype; on the card both are then
timed (CUDA events, median of ``--iters`` runs). Appends one JSON line per
configuration to ``--out`` and prints the worst relative error; like the
JAX sweep, it records errors and does not judge them.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np
import torch

from ..ops.neighborhood import nfp_reference
from ..ops.nfp_cuda import nfp_kernel
from .common import OUT_DIR, append_record, card, checked_call, median_ms

# (label, shape BHWC, radius, dilation, padding, dtype, measure, fuse_gap)
CONFIGS = [
    ("r2_head", (4, 9, 9, 32), 2, 1, 2, "float32", "cosine", False),
    ("r2_large", (2, 40, 40, 16), 2, 1, 2, "float32", "cosine", False),
    ("dilation2", (2, 15, 15, 24), 1, 2, 2, "float32", "cosine", False),
    ("dilation2_large", (2, 40, 40, 16), 1, 2, 2, "float32", "rmse", False),
    ("bf16_head", (4, 7, 7, 64), 1, 1, 1, "bfloat16", "cosine", False),
    ("bf16_large", (2, 56, 56, 24), 1, 1, 1, "bfloat16", "cosine", False),
    ("odd_w", (2, 13, 11, 24), 1, 1, 1, "float32", "cosine", False),
    ("odd_w_large", (2, 33, 29, 16), 1, 1, 1, "float32", "norm", False),
    ("gap_r2", (2, 40, 40, 16), 2, 1, 2, "float32", "cosine", True),
    ("gap_bf16", (2, 56, 56, 24), 1, 1, 1, "bfloat16", "cosine", True),
    # K3: measures without a channel-sum form on maps above 256 positions
    ("pearson_r2_large", (2, 40, 40, 16), 2, 1, 2, "float32", "pearson", False),
    ("pearson_odd_w_large", (2, 33, 29, 16), 1, 1, 1, "float32", "pearson", False),
    ("pearson_bf16_large", (2, 56, 56, 24), 1, 1, 1, "bfloat16", "pearson", False),
    ("pearson_gap_r2", (2, 40, 40, 16), 2, 1, 2, "float32", "pearson", True),
]


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--configs", nargs="+", default=None, help="subset of config labels")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--out", default=os.path.join(OUT_DIR, "sweep_nfp_kernel.jsonl"))
    args = ap.parse_args(argv)

    where = card(args.device)
    rng = np.random.default_rng(0)
    worst = 0.0
    for (label, shape, r, dil, pad, dtype, measure, fuse) in CONFIGS:
        if args.configs and label not in args.configs:
            continue
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
            device=args.device, dtype=getattr(torch, dtype))
        kw = dict(padding=pad, dilation=dil, fuse_gap=fuse)
        out, ref, route = checked_call(x, r, measure, **kw)
        err = (out.float() - ref.float()).abs().max().item()
        denom = ref.float().abs().max().item() or 1.0
        kernel_ms = plain_ms = None
        if args.device == "cuda" and args.iters > 0:
            kernel_ms = median_ms(lambda: nfp_kernel(x, r, measure, **kw),
                                  args.iters, args.warmup)
            plain_ms = median_ms(lambda: nfp_reference(x, r, measure, **kw),
                                 args.iters, args.warmup)
        append_record(args.out, {
            "config": label, "shape": list(shape), "radius": r, "dilation": dil,
            "padding": pad, "dtype": dtype, "measure": measure, "fuse_gap": fuse,
            "route": route, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
            "max_err": err, "max_rel_err": err / denom, **where})
        worst = max(worst, err / denom)
    print(f"# worst relative error over sweep: {worst:.2e}")


if __name__ == "__main__":
    main()
