"""What the card tools share: the device, one checked ``nfp_kernel`` call,
CUDA-event timing and the JSON-lines output."""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import time
from typing import Callable, Dict, Optional

import torch

from ..ops.neighborhood import nfp_reference
from ..ops.nfp_cuda import _ROUTE_WRAPPERS, _kernel_route, nfp_kernel

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
#: git-ignored directory the tools write into by default
OUT_DIR = os.path.join(REPO, "logs")


def card(device: str) -> Dict[str, Optional[str]]:
    """The device a record was taken on: for ``cuda``, the card's name and
    ``nvidia-smi``'s name and power limit; raises when there is no card."""
    if device == "cpu":
        return {"device": "cpu", "kind": None, "smi": None}
    if not torch.cuda.is_available():
        raise SystemExit("--device cuda needs a CUDA card and none is available; "
                         "pass --device cpu to run the plain version on the CPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip()
    return {"device": "cuda", "kind": torch.cuda.get_device_name(0), "smi": smi}


def launch_counts() -> Dict[str, int]:
    return {route: w.launches for route, w in _ROUTE_WRAPPERS.items()}


def checked_call(x: torch.Tensor, radius: int, measure: str, chw_body: str = "auto",
                 **kw):
    """One ``nfp_kernel`` call and the plain version on the same values.

    Returns ``(out, ref, route)``: ``ref`` is ``nfp_reference`` run in fp32
    and rounded once to the input dtype, as the kernels' fp32 result is.
    On the card, raises unless exactly one launch of ``route``'s kernel
    happened."""
    route = _kernel_route(tuple(x.shape), radius, measure, kw.get("padding", 0),
                          kw.get("dilation", 1), chw_body)
    before = launch_counts()
    out = nfp_kernel(x, radius, measure, chw_body=chw_body, **kw)
    moved = {k: v - before[k] for k, v in launch_counts().items()}
    if x.is_cuda and moved != {k: int(k == route) for k in moved}:
        raise AssertionError(f"nfp_kernel launched {moved}, expected one {route} launch")
    ref = nfp_reference(x.float(), radius, measure, **kw).to(x.dtype)
    return out, ref, route


def median_ms(fn: Callable[[], object], runs: int, warmup: int) -> float:
    """Median device time of ``fn`` over ``runs`` runs, each between two
    CUDA events, all queued behind a GPU sleep so host launch overhead is
    not timed."""
    for _ in range(max(warmup, 1)):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(runs)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(runs)]
    torch.cuda._sleep(int(min(2.0 * runs * host_s, 2.0) * 2e9))  # cycles
    for s, e in zip(starts, ends):
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def append_record(path: str, rec: dict) -> None:
    print(json.dumps(rec), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "a") as f:
        f.write(json.dumps(rec) + "\n")
