"""Sweep K2's plan on the card, and time K2 against the plain version
beyond the ``nfp`` dispatch caps.

    python -m neighbour_feature_pooling_tpu_torch.tools.sweep_k2_plan [--part plan|caps|both] [--out FILE]

``plan``: for the MobileNetV3 stage taps (112²×16, 56²×24, 28²×40) at B = 1,
32 and 128 (fused GAP, fp32, cosine, reflect padding 1), forces each
(output rows per step, steps per block, lanes per position G) in turn
through ``ops.nfp_cuda._k2_plan`` (whole channels and full-width strips;
the staged pixel stride follows from G), checks the output against the
plain version (rtol = atol = 1e-5) and times ``nfp_large_cuda`` twice (CUDA
events, median of 50). Each line is marked where it is the plan's own
choice.

``caps``: ``nfp_large_cuda`` (with its own plan) and ``nfp_reference`` at
(B, 56, 56, C) for B in 16, 32 and C in 48, 64, 96, 128, 256, map and fused,
checked the same way and timed beside each other: where K2 beats the plain
version on this card, against the JAX caps ``nfp`` routes by (C <= 48 for a
map, <= 64 fused).

Prints one JSON line per configuration and appends them to ``--out``
(default ``logs/sweep_k2_plan.jsonl``). Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import os
from unittest import mock

import torch

from ..ops import nfp_cuda
from ..ops.neighborhood import nfp_reference
from .common import OUT_DIR, append_record, card, median_ms

#: (H = W, C) of the taps -> (rows per step, steps per block, G) to try
TAPS = {
    (112, 16): [(st, n, g) for st in (1, 2, 4) for n in (1, 2, 4, 8) for g in (1, 2)],
    (56, 24): [(st, n, g) for st in (1, 2, 4) for n in (1, 2, 4) for g in (2, 4)],
    (28, 40): [(st, n, g) for st in (1, 2, 4) for n in (1, 2, 4) for g in (4, 8)],
}
BATCHES = (1, 32, 128)
CAPS_CHANNELS = (48, 64, 96, 128, 256)


def _sweep_plans(out, device, gen):
    for (s, c), options in TAPS.items():
        for b in BATCHES:
            x = torch.randn((b, s, s, c), generator=gen, device="cuda")
            ref = nfp_reference(x, 1, "cosine", padding=1, fuse_gap=True)
            own = nfp_cuda._k2_plan(b, s, s, c, s, s, 1, 1, x.dtype)
            for step, iters, group in options:
                rows = min(step * iters, s)
                stride = nfp_cuda._k2_stride(c // 4, group)
                smem = nfp_cuda._k2_smem_bytes(rows, step, s, stride, 1, 1)
                if smem > 227 * 1024:  # more than a block may take
                    continue
                plan = nfp_cuda.K2Plan(rows, step, s, -(-s // rows), 1, c, group, stride, smem)
                with mock.patch.object(nfp_cuda, "_k2_plan", lambda *a, plan=plan: plan):
                    def run():
                        return nfp_cuda.nfp_large_cuda(x, 1, "cosine", padding=1,
                                                       fuse_gap=True)
                    ok = torch.allclose(run(), ref, rtol=1e-5, atol=1e-5)
                    ms = [median_ms(run, 50, 3) for _ in range(2)]
                append_record(out, dict(
                    tool="sweep_k2_plan", part="plan", **device, shape=[b, s, s, c],
                    rows=rows, step=step, group=group, stride=stride, smem_bytes=smem, ok=ok,
                    kernel_ms=ms, plan=(rows, step, group) == (own.rows, own.step, own.group)))


def _sweep_caps(out, device, gen):
    for b in (16, 32):
        for c in CAPS_CHANNELS:
            x = torch.randn((b, 56, 56, c), generator=gen, device="cuda")
            for fuse_gap in (False, True):
                kw = dict(padding=1, fuse_gap=fuse_gap)
                got = nfp_cuda.nfp_large_cuda(x, 1, "cosine", **kw)
                ok = torch.allclose(got, nfp_reference(x, 1, "cosine", **kw),
                                    rtol=1e-5, atol=1e-5)
                plan = nfp_cuda._k2_plan(b, 56, 56, c, 56, 56, 1, 1, x.dtype)
                kernel_ms = median_ms(lambda: nfp_cuda.nfp_large_cuda(x, 1, "cosine", **kw), 50, 3)
                plain_ms = median_ms(lambda: nfp_reference(x, 1, "cosine", **kw), 50, 3)
                append_record(out, dict(
                    tool="sweep_k2_plan", part="caps", **device, shape=[b, 56, 56, c],
                    fuse_gap=fuse_gap, ok=ok, plan=list(plan[:8]), kernel_ms=kernel_ms,
                    plain_ms=plain_ms,
                    jax_route=nfp_cuda._route((b, 56, 56, c), 1, "cosine", 1, 1, 1, "NHWC",
                                              fuse_gap)))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--part", choices=["plan", "caps", "both"], default="both")
    ap.add_argument("--out", default=os.path.join(OUT_DIR, "sweep_k2_plan.jsonl"))
    args = ap.parse_args(argv)
    device = card("cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    if args.part in ("plan", "both"):
        _sweep_plans(args.out, device, gen)
    if args.part in ("caps", "both"):
        _sweep_caps(args.out, device, gen)


if __name__ == "__main__":
    main()
