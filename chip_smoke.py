#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; one CUDA card, nvcc

Drives ``neighbour_feature_pooling_tpu_torch`` (never JAX) on the card:

1. card: the device name and ``nvidia-smi``'s name and power limit;
2. build: compiles every kernel in ``csrc/`` with nvcc for sm_90a;
3. kernels: holds each kernel against its plain PyTorch version on the card
   at the serving shapes and a spread of measures and geometries, and times
   both (CUDA events, median of 50 runs queued behind a GPU sleep, so host
   launch overhead is not timed), beside the least time the card could
   take (bytes at 3.35 TB/s or fp32 operations at 67 TFLOP/s, whichever is
   larger);
4. serve: ResNet18 + texture_nfp ``Predictor`` on the card with seeded
   weights answers three requests (1, 32, 45 images), goes through the NFP
   kernel once per batch, and matches a CPU ``Predictor`` with the same
   weights (TF32 off); then the forward rate at B=32 and B=128.

Any failure raises and the exit code is non-zero. The last two lines are a
JSON record of each kernel and the ``{"ok": true, ...}`` line.
"""

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
FP32_FLOPS_PER_S = 67e12   # H100 SXM fp32, outside the tensor cores
RUNS = 50

#: fp32 operations per channel per (position, neighbour) pair, per measure
#: (the kernel's loop body: cosine = 3 multiplies + 3 adds, ...)
FLOPS_PER_TERM = {"cosine": 6, "scs": 6, "gfc": 6, "dot": 2, "attention": 2,
                  "norm": 4, "pearson": 10, "smith": 6, "jeffrey": 10,
                  "canberra": 8}


def median_ms(fn, runs=RUNS):
    """Median device time of ``fn`` over ``runs`` runs, each between two
    CUDA events. All runs are queued behind a GPU sleep long enough for the
    host to enqueue them, so the device runs them back to back."""
    for _ in range(3):
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


def bf16_ulp(v):
    """One bf16 ulp at each value (8 significant bits)."""
    _, exp = torch.frexp(v.float())
    return torch.ldexp(torch.ones_like(v, dtype=torch.float32), exp - 8)


def kernel_cases():
    """(label, shape, dtype, measure, kwargs) for the small-map NFP kernel."""
    cases = []
    for b in (32, 128):
        for dtype in (torch.float32, torch.bfloat16):
            for fuse_gap in (True, False):
                cases.append((f"serve B={b} {str(dtype)[6:]} fuse_gap={fuse_gap}",
                              (b, 7, 7, 512), dtype, "cosine",
                              dict(padding=1, fuse_gap=fuse_gap)))
    for measure, kw in (("dot", {}), ("attention", {}), ("attention", dict(fuse_gap=False)),
                        ("norm", dict(p=1.0)), ("norm", dict(p=2.0)), ("norm", dict(p=3.0)),
                        ("pearson", {}), ("smith", {}), ("scs", dict(p=2.0)),
                        ("jeffrey", {}), ("canberra", dict(similarity=False))):
        kw = dict(dict(padding=1, fuse_gap=True), **kw)
        label = measure + "".join(f" {k}={v}" for k, v in kw.items() if k != "padding")
        cases.append((label, (32, 7, 7, 512), torch.float32, measure, kw))
    cases += [
        ("vit head R=2 dilation=2", (8, 14, 14, 192), torch.float32, "cosine",
         dict(radius=2, dilation=2, padding=4, fuse_gap=True)),
        ("vit head R=2 dilation=2 map", (8, 14, 14, 192), torch.float32, "cosine",
         dict(radius=2, dilation=2, padding=4)),
        ("1x1 reflect", (32, 1, 1, 512), torch.float32, "cosine", dict(padding=1, fuse_gap=True)),
        ("2x2 reflect", (32, 2, 2, 512), torch.float32, "cosine", dict(padding=1)),
        ("C=30 scalar loads, zeros pad 2", (4, 7, 7, 30), torch.float32, "cosine",
         dict(padding=2, padding_mode="zeros")),
    ]
    return cases


def check_kernels(nfp_small_cuda, nfp_reference, num_neighbors, nfp_output_size):
    """Every case against the plain version; returns the serving case's row."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    serve_row = None
    for label, shape, dtype, measure, kw in kernel_cases():
        kw = dict(kw)
        radius = kw.pop("radius", 1)
        x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        out = nfp_small_cuda(x, radius, measure, **kw)
        torch.cuda.synchronize()
        # the plain version fed the same values (bf16 → fp32 is exact),
        # rounded once to the input dtype as the kernel's fp32 result is
        ref = nfp_reference(x.float(), radius, measure, **kw).to(dtype)
        err = (out.float() - ref.float()).abs().max().item()
        if not torch.isfinite(out).all():
            raise AssertionError(f"{label}: non-finite kernel output")
        if out.shape != ref.shape or out.dtype != ref.dtype:
            raise AssertionError(f"{label}: kernel gave {out.shape} {out.dtype}, "
                                 f"plain version {ref.shape} {ref.dtype}")
        if dtype == torch.float32:
            if not torch.allclose(out, ref, rtol=1e-5, atol=1e-5):
                raise AssertionError(f"{label}: max |err| {err:.3e} over rtol=atol=1e-5")
        else:
            # one bf16 ulp; near zero, where a bf16 ulp falls below the fp32
            # rounding of the channel sums, the fp32 atol of 1e-5
            tol = torch.maximum(bf16_ulp(out), bf16_ulp(ref)).clamp(min=1e-5)
            if ((out.float() - ref.float()).abs() > tol).any():
                raise AssertionError(f"{label}: bf16 kernel output off by more than one ulp "
                                     f"(max |diff| {err})")
        k_ms = median_ms(lambda: nfp_small_cuda(x, radius, measure, **kw))
        p_ms = median_ms(lambda: nfp_reference(x, radius, measure, **kw))
        b, h, w, c = shape
        pad, dil = kw.get("padding", 0), kw.get("dilation", 1)
        positions = (nfp_output_size(h, radius, 1, pad, dil)
                     * nfp_output_size(w, radius, 1, pad, dil))
        n_bytes = x.numel() * x.element_size() + out.numel() * out.element_size()
        n_flops = b * positions * num_neighbors(radius) * c * FLOPS_PER_TERM[measure]
        bytes_ms, flops_ms = n_bytes / HBM_BYTES_PER_S * 1e3, n_flops / FP32_FLOPS_PER_S * 1e3
        row = dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=max(bytes_ms, flops_ms),
                   bound_by="bytes" if bytes_ms >= flops_ms else "operations")
        print(f"  {label:42s} {str(tuple(shape)):18s} max|err| {err:.3e}  kernel {k_ms * 1e3:9.2f} us"
              f"  plain {p_ms * 1e3:9.2f} us  bound {row['bound_ms'] * 1e3:6.2f} us ({row['bound_by']})")
        if label == "serve B=32 float32 fuse_gap=True":
            serve_row = row
    return serve_row


def serve(Predictor, nfp_small_cuda):
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"serve: torch.backends.cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"torch.backends.cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    kw = dict(model_type="resnet18", model_variant="texture_nfp", num_classes=21,
              batch_size=32, input_size=224)
    t0 = time.perf_counter()
    pred = Predictor(**kw, device="cuda")
    print(f"serve: Predictor(resnet18, texture_nfp, 21 classes, batch_size=32, 224 px) "
          f"on cuda in {time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(0)
    requests = [[rng.random((int(rng.integers(180, 361)), int(rng.integers(180, 361)), 3),
                            dtype=np.float32) for _ in range(n)] for n in (1, 32, 45)]
    pred.predict(requests[0])  # warm-up: cuDNN plans, first launches

    nfp_small_cuda.launches = 0
    outs, lat = [], []
    for req in requests:
        t0 = time.perf_counter()
        outs.append(pred.predict(req))
        lat.append(time.perf_counter() - t0)
    launches = nfp_small_cuda.launches

    for req, out in zip(requests, outs):
        probs = out["probabilities"]
        if probs.shape != (len(req), 21) or out["label"].shape != (len(req),):
            raise AssertionError(f"serve: bad output shapes {probs.shape}, {out['label'].shape}")
        if not np.isfinite(probs).all():
            raise AssertionError("serve: non-finite probabilities")
        np.testing.assert_allclose(probs.sum(-1), 1.0, atol=1e-5)
    expected = sum(-(-len(r) // 32) for r in requests)
    if launches != expected:
        raise AssertionError(f"serve: nfp_small launched {launches} times, expected {expected}")
    pre = []
    for req in requests:
        t0 = time.perf_counter()
        pred.preprocess(req)
        pre.append(time.perf_counter() - t0)
    print(f"serve: requests of {[len(r) for r in requests]} images answered in "
          f"{[round(t * 1e3, 2) for t in lat]} ms, of which host preprocessing "
          f"{[round(t * 1e3, 2) for t in pre]} ms; nfp_small launches {launches} (= batches)")
    batch = pred.preprocess(requests[1])
    t0 = time.perf_counter()
    torch.from_numpy(batch).to("cuda")
    torch.cuda.synchronize()
    copy_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pred.predict(batch, preprocessed=True)
    print(f"serve: one preprocessed batch of 32: predict {(time.perf_counter() - t0) * 1e3:.2f} ms, "
          f"while a host-to-device copy of its {batch.nbytes / 1e6:.1f} MB alone takes {copy_s * 1e3:.2f} ms")

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "weights.pt")
        torch.save(pred.model.state_dict(), path)
        cpu = Predictor(**kw, checkpoint=path, device="cpu")
    worst = 0.0
    for req, out in zip(requests, outs):
        want = cpu.predict(pred.preprocess(req), preprocessed=True)
        np.testing.assert_array_equal(out["label"], want["label"])
        worst = max(worst, float(np.abs(out["probabilities"] - want["probabilities"]).max()))
    if worst > 1e-4:
        raise AssertionError(f"serve: max |dprob| vs the CPU predictor {worst:.3e} > 1e-4")
    print(f"serve: matches the CPU Predictor: labels equal, max |dprob| {worst:.3e} (<= 1e-4)")

    gen = torch.Generator(device="cuda").manual_seed(1)
    model = pred.model
    for b in (32, 128):
        x = torch.randn((b, 224, 224, 3), generator=gen, device="cuda")
        with torch.inference_mode():
            fmap = model.backbone(x)
            ms = median_ms(lambda: model(x), runs=20)
            backbone_ms = median_ms(lambda: model.backbone(x), runs=20)
            head_ms = median_ms(lambda: model.fc(model.pool(fmap)), runs=20)
        print(f"serve: forward B={b} fp32 {ms:.3f} ms/batch = {b / ms * 1e3:.1f} img/s; "
              f"backbone {backbone_ms:.3f} ms, NFP head + fc {head_ms:.3f} ms "
              f"(median of 20, CUDA events)")
    return launches


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py needs a CUDA device and none is available")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from neighbour_feature_pooling_tpu_torch.ops import _build
    from neighbour_feature_pooling_tpu_torch.ops.neighborhood import (
        nfp_output_size, nfp_reference, num_neighbors)
    from neighbour_feature_pooling_tpu_torch.ops.nfp_cuda import nfp_small_cuda
    from neighbour_feature_pooling_tpu_torch.serve import Predictor

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip()
    print(f"card: {name}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(smi)

    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"build: {len(_build.kernel_names())} kernel source(s), {len(logs)} compiled, "
          f"in {time.perf_counter() - t0:.2f} s")
    for kernel, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {kernel}: {line.strip()}")

    print("kernels: nfp_small against nfp_reference on the card "
          "(fp32 rtol=atol=1e-5; bf16 within one bf16 ulp)")
    serve_row = check_kernels(nfp_small_cuda, nfp_reference, num_neighbors, nfp_output_size)
    launches = serve(Predictor, nfp_small_cuda)

    print(json.dumps({"kernels": [dict(
        name="nfp_small", route="cuda",
        source="neighbour_feature_pooling_tpu_torch/csrc/nfp_small.cu",
        replaces="neighbour_feature_pooling_tpu/ops/nfp_pallas.py:69",
        launches=launches, library_ms=None, **serve_row)]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
