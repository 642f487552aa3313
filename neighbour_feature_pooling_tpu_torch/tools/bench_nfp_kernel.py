"""The direct NFP kernel entry against the plain version, timed on the card.

    python -m neighbour_feature_pooling_tpu_torch.tools.bench_nfp_kernel [--measure pearson]

Counterpart of the JAX package's ``scripts/bench_nfp_kernel.py``, at the
same shapes: the MobileNetV3 multi-stage taps and the ResNet layer1 tap,
B=16, R=1, reflect padding 1, fused GAP on and off. Each configuration goes
once through ``ops.nfp_kernel`` (``cosine`` reaches K2, ``pearson`` K3),
is held against ``nfp_reference`` (fp32 rtol = atol = 1e-5) and, on the
card, checked to have launched its route's kernel once; then both are timed
with CUDA events (median of ``--iters`` runs). Appends one JSON line per
(shape, fused) to ``--out``. ``--iters 0`` checks without timing;
``--device cpu`` runs the plain version on the CPU and times nothing.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..ops.neighborhood import nfp_reference
from ..ops.nfp_cuda import nfp_kernel
from .common import OUT_DIR, append_record, card, checked_call, median_ms

SHAPES = [
    # (label, B, H, W, C)
    ("mnv3_stage1", 16, 112, 112, 16),
    ("mnv3_stage2", 16, 56, 56, 24),
    ("mnv3_stage3", 16, 28, 28, 40),
    ("resnet_layer1", 16, 56, 56, 64),
]
FUSE_OPTS = {"on": (True,), "off": (False,), "both": (True, False)}


def run(measure: str = "cosine", shapes: Optional[Sequence[str]] = None,
        fuse_gap: str = "both", iters: int = 50, warmup: int = 5,
        chw_body: str = "auto", device: str = "cuda") -> List[dict]:
    """One record per (shape, fused); raises if the kernel entry disagrees
    with the plain version or, on the card, launched another kernel than
    its route's."""
    where = card(device)
    rng = np.random.default_rng(0)
    records = []
    for label, b, h, w, c in SHAPES:
        if shapes and label not in shapes:
            continue
        x = torch.from_numpy(rng.standard_normal((b, h, w, c)).astype(np.float32)).to(device)
        for fuse in FUSE_OPTS[fuse_gap]:
            kw = dict(padding=1, fuse_gap=fuse)
            out, ref, route = checked_call(x, 1, measure, chw_body, **kw)
            err = (out - ref).abs().max().item()
            if not torch.allclose(out, ref, rtol=1e-5, atol=1e-5):
                raise AssertionError(f"{label} {measure} fuse_gap={fuse}: max |err| {err:.3e} "
                                     f"over rtol=atol=1e-5")
            kernel_ms = plain_ms = None
            if device == "cuda" and iters > 0:
                kernel_ms = median_ms(lambda: nfp_kernel(x, 1, measure, chw_body=chw_body, **kw),
                                      iters, warmup)
                plain_ms = median_ms(lambda: nfp_reference(x, 1, measure, **kw), iters, warmup)
            records.append({
                "shape": label, "B": b, "H": h, "W": w, "C": c, "measure": measure,
                "fuse_gap": fuse, "chw_body": chw_body, "route": route,
                "kernel_ms": kernel_ms, "plain_ms": plain_ms,
                "speedup": plain_ms / kernel_ms if kernel_ms else None,
                "max_err": err, **where})
    return records


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--measure", default="cosine")
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--warmup", type=int, default=5)
    ap.add_argument("--shapes", nargs="+", default=None, help="subset of shape labels")
    ap.add_argument("--fuse_gap", choices=sorted(FUSE_OPTS), default="both")
    ap.add_argument("--chw_body", choices=["auto", "fori", "vec"], default="auto",
                    help="the JAX channels-first body choice; all three run K2 on the card")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--out", default=os.path.join(OUT_DIR, "bench_nfp_kernel.jsonl"))
    args = ap.parse_args(argv)
    for rec in run(args.measure, args.shapes, args.fuse_gap, args.iters, args.warmup,
                   args.chw_body, args.device):
        append_record(args.out, rec)


if __name__ == "__main__":
    main()
