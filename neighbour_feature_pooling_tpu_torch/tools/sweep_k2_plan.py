"""Sweep the plan of K2 (or of K3, with ``--measure pearson``) on the card,
and time the kernel against the plain version beyond the ``nfp`` dispatch
caps.

    python -m neighbour_feature_pooling_tpu_torch.tools.sweep_k2_plan [--part plan|caps|both] [--measure M] [--out FILE]

``--measure`` (default ``cosine``) picks the kernel: ``nfp_large_cuda`` (K2)
for a separable measure, ``nfp_strip_cuda`` (K3, the same kernel template
and plan) for ``pearson``.

``plan``: for the MobileNetV3 stage taps (112²×16, 56²×24, 28²×40) at B = 1,
32 and 128 (fused GAP, fp32, reflect padding 1), forces each (output rows
per step, steps per block, lanes per position G) in turn through
``ops.nfp_cuda._k2_plan`` (whole channels and full-width strips; the staged
pixel stride follows from G), checks the output against the plain version
(rtol = atol = 1e-5) and times the kernel twice (CUDA events, median of 50).
Each line is marked where it is the plan's own choice.

``caps``: the kernel (with its own plan) and ``nfp_reference`` at (B, 56,
56, C) for B in 16, 32 and C in 48, 64, 96, 128, 256, map and fused,
checked the same way and timed beside each other: where the kernel beats
the plain version on this card, against the JAX caps ``nfp`` routes by (C
<= 48 for a map, <= 64 fused).

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


def _kernel(measure):
    """K3's wrapper for ``pearson``, K2's for the separable measures."""
    return nfp_cuda.nfp_strip_cuda if measure == "pearson" else nfp_cuda.nfp_large_cuda


def _sweep_plans(out, device, gen, measure):
    kernel = _kernel(measure)
    pixel_floats = nfp_cuda._k2_pixel_floats(measure)
    for (s, c), options in TAPS.items():
        for b in BATCHES:
            x = torch.randn((b, s, s, c), generator=gen, device="cuda")
            ref = nfp_reference(x, 1, measure, padding=1, fuse_gap=True)
            own = nfp_cuda._k2_plan(b, s, s, c, s, s, 1, 1, x.dtype, measure)
            for step, iters, group in options:
                rows = min(step * iters, s)
                stride = nfp_cuda._k2_stride(c // 4, group)
                smem = nfp_cuda._k2_smem_bytes(rows, step, s, stride, 1, 1, pixel_floats)
                if smem > 227 * 1024:  # more than a block may take
                    continue
                plan = nfp_cuda.K2Plan(rows, step, s, -(-s // rows), 1, c, group, stride, smem)
                with mock.patch.object(nfp_cuda, "_k2_plan", lambda *a, plan=plan: plan):
                    def run():
                        return kernel(x, 1, measure, padding=1, fuse_gap=True)
                    ok = torch.allclose(run(), ref, rtol=1e-5, atol=1e-5)
                    ms = [median_ms(run, 50, 3) for _ in range(2)]
                append_record(out, dict(
                    tool="sweep_k2_plan", part="plan", **device, measure=measure,
                    shape=[b, s, s, c], rows=rows, step=step, group=group, stride=stride,
                    smem_bytes=smem, ok=ok, kernel_ms=ms,
                    plan=(rows, step, group) == (own.rows, own.step, own.group)))


def _sweep_caps(out, device, gen, measure):
    kernel = _kernel(measure)
    for b in (16, 32):
        for c in CAPS_CHANNELS:
            x = torch.randn((b, 56, 56, c), generator=gen, device="cuda")
            for fuse_gap in (False, True):
                kw = dict(padding=1, fuse_gap=fuse_gap)
                got = kernel(x, 1, measure, **kw)
                ok = torch.allclose(got, nfp_reference(x, 1, measure, **kw),
                                    rtol=1e-5, atol=1e-5)
                plan = nfp_cuda._k2_plan(b, 56, 56, c, 56, 56, 1, 1, x.dtype, measure)
                kernel_ms = median_ms(lambda: kernel(x, 1, measure, **kw), 50, 3)
                plain_ms = median_ms(lambda: nfp_reference(x, 1, measure, **kw), 50, 3)
                append_record(out, dict(
                    tool="sweep_k2_plan", part="caps", **device, measure=measure,
                    shape=[b, 56, 56, c], fuse_gap=fuse_gap, ok=ok, plan=list(plan[:8]),
                    kernel_ms=kernel_ms, plain_ms=plain_ms,
                    jax_route=nfp_cuda._route((b, 56, 56, c), 1, measure, 1, 1, 1, "NHWC",
                                              fuse_gap)))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--part", choices=["plan", "caps", "both"], default="both")
    ap.add_argument("--measure", default="cosine",
                    help="cosine (or another separable measure) sweeps K2, pearson K3")
    ap.add_argument("--out", default=os.path.join(OUT_DIR, "sweep_k2_plan.jsonl"))
    args = ap.parse_args(argv)
    device = card("cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    if args.part in ("plan", "both"):
        _sweep_plans(args.out, device, gen, args.measure)
    if args.part in ("caps", "both"):
        _sweep_caps(args.out, device, gen, args.measure)


if __name__ == "__main__":
    main()
