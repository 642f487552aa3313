"""Sweep K1's plan on the card: rows per tile and lanes per pair.

    python -m neighbour_feature_pooling_tpu_torch.tools.sweep_k1_plan [--out FILE]

For the ResNet18 head and the MobileNetV3 14² and 7² taps at B = 1, 32 and
128 (fused GAP, fp32, cosine, reflect padding 1), forces each (rows, G)
in turn through ``ops.nfp_cuda._k1_plan`` (the channel chunk follows from
the rows), checks the output against the plain version (rtol = atol =
1e-5) and times ``nfp_small_cuda`` twice (CUDA events, median of 50).
Prints one JSON line per configuration, marked where it is the plan's own
choice, and appends them to ``--out`` (default ``logs/sweep_k1_plan.jsonl``).
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import os
from unittest import mock

import torch

from ..ops import nfp_cuda
from ..ops.neighborhood import nfp_reference
from .common import OUT_DIR, append_record, card, median_ms

#: (B, H, W, C) -> (rows per tile, lanes per pair) to try
SWEEP = {
    (1, 7, 7, 512): ((1, 2, 7), (4, 8, 16, 32)),
    (32, 7, 7, 512): ((1, 2, 7), (4, 8, 16)),
    (128, 7, 7, 512): ((1, 2, 3, 7), (4, 8)),
    (32, 14, 14, 112): ((2, 3, 4), (4, 8)),
    (128, 14, 14, 112): ((2, 3, 5), (4, 8)),
    (32, 7, 7, 960): ((1, 2), (4, 8, 16)),
    (128, 7, 7, 960): ((1, 2, 3), (4, 8)),
}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(OUT_DIR, "sweep_k1_plan.jsonl"))
    args = ap.parse_args(argv)
    device = card("cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for shape, (rows_opts, groups) in SWEEP.items():
        b, h, w, c = shape
        x = torch.randn(shape, generator=gen, device="cuda")
        ref = nfp_reference(x, 1, "cosine", padding=1, fuse_gap=True)
        own = nfp_cuda._k1_plan(b, h, w, c, h, w, 1, 1, x.dtype)
        for rows in rows_opts:
            chunk, smem = nfp_cuda._k1_chunk(rows, c, w, 1, 1, x.dtype)
            for group in groups:
                plan = nfp_cuda.K1Plan(rows, -(-h // rows), chunk, group, smem)
                with mock.patch.object(nfp_cuda, "_k1_plan", lambda *a, plan=plan: plan):
                    def run():
                        return nfp_cuda.nfp_small_cuda(x, 1, "cosine", padding=1,
                                                       fuse_gap=True)
                    ok = torch.allclose(run(), ref, rtol=1e-5, atol=1e-5)
                    ms = [median_ms(run, 50, 3) for _ in range(2)]
                append_record(args.out, dict(
                    tool="sweep_k1_plan", **device, shape=list(shape), rows=rows,
                    group=group, chunk=chunk, ok=ok, kernel_ms=ms,
                    plan=(rows, group, chunk) == (own.rows, own.group, own.chunk)))


if __name__ == "__main__":
    main()
