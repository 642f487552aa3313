#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; one CUDA card, nvcc

Drives ``neighbour_feature_pooling_tpu_torch`` (never JAX) on the card:

1. card: the device name and ``nvidia-smi``'s name and power limit;
2. build: compiles every kernel in ``csrc/`` with nvcc for sm_90a, one
   nvcc per source, all at once;
3. kernels: holds each kernel against its plain PyTorch version on the card
   at the main paths' shapes and a spread of measures and geometries, and
   times both (CUDA events, median of 50 runs queued behind a GPU sleep, so
   host launch overhead is not timed), beside the least time the card could
   take (bytes at 3.35 TB/s or fp32 operations at 67 TFLOP/s, whichever is
   larger): K1 (``nfp_small``) and K2 (``nfp_large``);
4. serve ResNet18: a ResNet18 + texture_nfp ``Predictor`` on the card with
   seeded weights answers three requests (1, 32, 45 images), goes through
   K1 once per batch, and matches a CPU ``Predictor`` with the same weights
   (TF32 off); then the forward rate at B=32 and B=128;
5. serve MobileNetV3: the same for MobileNetV3-Large + multi_stage_nfp,
   which runs K2 on the 112², 56² and 28² taps and K1 on the 14² and 7²
   ones (3 and 2 launches per batch), with the forward split into the
   backbone and the NFP taps + projections + fc;
6. the other MobileNetV3 variants: one batch each on the card against the
   CPU, with each one's launch counts.

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
                  "canberra": 8, "rmse": 3, "geman": 5, "emd": 3,
                  "hellinger": 8, "squaredchord": 8, "chisquared1": 8,
                  "chisquared2": 6}
MNV3_VARIANTS = ("gap_only", "texture_nfp", "texture_nfp_intermediate", "mid_nfp",
                 "multi_stage_nfp", "nfp_insert")
#: (nfp_large, nfp_small) launches per forward of each MobileNetV3 variant
MNV3_LAUNCHES = {"multi_stage_nfp": (3, 2), "mid_nfp": (1, 0),
                 "texture_nfp_intermediate": (1, 0), "nfp_insert": (1, 0),
                 "texture_nfp": (0, 1), "gap_only": (0, 0)}


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


def k1_cases():
    """(label, shape, dtype, measure, kwargs) for the small-map kernel K1."""
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
        ("mnv3 tap 4 B=32", (32, 14, 14, 112), torch.float32, "cosine",
         dict(padding=1, fuse_gap=True)),
        ("mnv3 tap 5 B=32", (32, 7, 7, 960), torch.float32, "cosine",
         dict(padding=1, fuse_gap=True)),
    ]
    return cases


K2_MAIN = "tap 1 B=32 float32"


def k2_cases():
    """(label, shape, dtype, measure, kwargs) for the large-map kernel K2."""
    gap = dict(padding=1, fuse_gap=True)
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for tap, (s, c) in enumerate(((112, 16), (56, 24), (28, 40)), start=1):
            cases.append((f"tap {tap} B=32 {str(dtype)[6:]}", (32, s, s, c), dtype,
                          "cosine", gap))
    cases += [
        ("tap 1 B=128 float32", (128, 112, 112, 16), torch.float32, "cosine", gap),
        ("nfp_insert map, padding 0", (32, 56, 56, 24), torch.float32, "cosine",
         dict(padding=0)),
    ]
    for measure, kw in (("norm", dict(p=1.0)), ("norm", dict(p=2.0)), ("norm", dict(p=3.0)),
                        ("cosine", dict(similarity=False)), ("dot", {}), ("attention", {}),
                        ("attention", dict(fuse_gap=False)), ("rmse", {}), ("geman", {}),
                        ("emd", {}), ("canberra", {}), ("hellinger", {}), ("chisquared1", {}),
                        ("chisquared2", {}), ("gfc", {}), ("jeffrey", {}),
                        ("squaredchord", {}), ("smith", dict(similarity=False)),
                        ("scs", dict(p=2.0))):
        kw = dict(gap, **kw)
        label = measure + "".join(f" {k}={v}" for k, v in kw.items() if k != "padding")
        cases.append((label, (8, 56, 56, 24), torch.float32, measure, kw))
    for mode in ("zeros", "reflect", "replicate", "circular"):
        cases.append((f"{mode} pad 2 map", (8, 56, 56, 24), torch.float32, "cosine",
                      dict(padding=2, padding_mode=mode)))
    cases += [
        ("odd 57x43", (8, 57, 43, 24), torch.float32, "cosine", gap),
        ("odd 57x43 map", (8, 57, 43, 24), torch.float32, "cosine", dict(padding=1)),
        ("R=2 dilation=2", (8, 56, 56, 24), torch.float32, "cosine",
         dict(radius=2, dilation=2, padding=4, fuse_gap=True)),
        ("R=2 dilation=2 map", (8, 56, 56, 24), torch.float32, "cosine",
         dict(radius=2, dilation=2, padding=4)),
        ("C=30 scalar loads", (8, 56, 56, 30), torch.float32, "cosine", gap),
        ("C=30 scalar loads bf16 map", (8, 56, 56, 30), torch.bfloat16, "cosine",
         dict(padding=1)),
        ("C=48 map (cap edge)", (32, 56, 56, 48), torch.float32, "cosine", dict(padding=1)),
        ("C=64 fused (cap edge)", (32, 56, 56, 64), torch.float32, "cosine", gap),
        ("C=64 map (out of cap)", (32, 56, 56, 64), torch.float32, "cosine", dict(padding=1)),
        ("C=96 fused (out of cap)", (32, 56, 56, 96), torch.float32, "cosine", gap),
    ]
    return cases


def check_kernel(wrapper, cases, main_label, nfp_reference, num_neighbors, nfp_output_size):
    """Every case against the plain version; returns the main-path case's row."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    main_row = None
    for label, shape, dtype, measure, kw in cases:
        kw = dict(kw)
        radius = kw.pop("radius", 1)
        x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        out = wrapper(x, radius, measure, **kw)
        if not torch.equal(out, wrapper(x, radius, measure, **kw)):
            raise AssertionError(f"{label}: two launches on the same input differ")
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
        k_ms = median_ms(lambda: wrapper(x, radius, measure, **kw))
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
        if label == main_label:
            main_row = row
    return main_row


def device_profile(fn, steps=5):
    """Device time per call of ``fn`` summed over its kernels, kernels per
    call, and the three kernels with the most device time, from a
    ``torch.profiler`` trace of ``steps`` calls."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total / 1e3 / steps
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:3]
    return busy, len(kernels) / steps, top


def requests_of(rng):
    return [[rng.random((int(rng.integers(180, 361)), int(rng.integers(180, 361)), 3),
                        dtype=np.float32) for _ in range(n)] for n in (1, 32, 45)]


def match_cpu(Predictor, pred, kw, batches, tag):
    """The card's answers against a CPU Predictor with the same weights:
    labels equal and max |dprob| <= 1e-4. ``batches`` are (preprocessed
    images, the card's output) pairs."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "weights.pt")
        torch.save(pred.model.state_dict(), path)
        cpu = Predictor(**kw, checkpoint=path, device="cpu")
    worst = 0.0
    for images, out in batches:
        want = cpu.predict(images, preprocessed=True)
        np.testing.assert_array_equal(out["label"], want["label"])
        worst = max(worst, float(np.abs(out["probabilities"] - want["probabilities"]).max()))
    if worst > 1e-4:
        raise AssertionError(f"{tag}: max |dprob| vs the CPU predictor {worst:.3e} > 1e-4")
    print(f"{tag}: matches the CPU Predictor: labels equal, max |dprob| {worst:.3e} (<= 1e-4)")


def answer(pred, requests, tag):
    """Answer each request, checking shapes and probabilities; returns the
    outputs and host latencies."""
    outs, lat = [], []
    for req in requests:
        t0 = time.perf_counter()
        outs.append(pred.predict(req))
        lat.append(time.perf_counter() - t0)
    for req, out in zip(requests, outs):
        probs = out["probabilities"]
        if probs.shape != (len(req), pred.num_classes) or out["label"].shape != (len(req),):
            raise AssertionError(f"{tag}: bad output shapes {probs.shape}, {out['label'].shape}")
        if not np.isfinite(probs).all():
            raise AssertionError(f"{tag}: non-finite probabilities")
        np.testing.assert_allclose(probs.sum(-1), 1.0, atol=1e-5)
    return outs, lat


def serve_resnet18(Predictor, nfp_small_cuda, nfp_large_cuda):
    """The first slice's main path; returns its launches of each kernel."""
    kw = dict(model_type="resnet18", model_variant="texture_nfp", num_classes=21,
              batch_size=32, input_size=224)
    t0 = time.perf_counter()
    pred = Predictor(**kw, device="cuda")
    print(f"serve resnet18: Predictor(resnet18, texture_nfp, 21 classes, batch_size=32, "
          f"224 px) on cuda in {time.perf_counter() - t0:.2f} s")
    requests = requests_of(np.random.default_rng(0))
    pred.predict(requests[0])  # warm-up: cuDNN plans, first launches

    nfp_small_cuda.launches = nfp_large_cuda.launches = 0
    outs, lat = answer(pred, requests, "serve resnet18")
    launches = dict(nfp_small=nfp_small_cuda.launches, nfp_large=nfp_large_cuda.launches)

    expected = sum(-(-len(r) // 32) for r in requests)
    if launches != dict(nfp_small=expected, nfp_large=0):
        raise AssertionError(f"serve resnet18: launches {launches}, expected "
                             f"nfp_small {expected} (= batches), nfp_large 0")
    pre = []
    for req in requests:
        t0 = time.perf_counter()
        pred.preprocess(req)
        pre.append(time.perf_counter() - t0)
    print(f"serve resnet18: requests of {[len(r) for r in requests]} images answered in "
          f"{[round(t * 1e3, 2) for t in lat]} ms, of which host preprocessing "
          f"{[round(t * 1e3, 2) for t in pre]} ms; launches {launches}")
    batch = pred.preprocess(requests[1])
    t0 = time.perf_counter()
    torch.from_numpy(batch).to("cuda")
    torch.cuda.synchronize()
    copy_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pred.predict(batch, preprocessed=True)
    print(f"serve resnet18: one preprocessed batch of 32: predict "
          f"{(time.perf_counter() - t0) * 1e3:.2f} ms, while a host-to-device copy of its "
          f"{batch.nbytes / 1e6:.1f} MB alone takes {copy_s * 1e3:.2f} ms")
    match_cpu(Predictor, pred, kw, [(pred.preprocess(r), o) for r, o in zip(requests, outs)],
              "serve resnet18")

    gen = torch.Generator(device="cuda").manual_seed(1)
    model = pred.model
    for b in (32, 128):
        x = torch.randn((b, 224, 224, 3), generator=gen, device="cuda")
        with torch.inference_mode():
            fmap = model.backbone(x)
            ms = median_ms(lambda: model(x), runs=20)
            backbone_ms = median_ms(lambda: model.backbone(x), runs=20)
            head_ms = median_ms(lambda: model.fc(model.pool(fmap)), runs=20)
        print(f"serve resnet18: forward B={b} fp32 {ms:.3f} ms/batch = {b / ms * 1e3:.1f} img/s; "
              f"backbone {backbone_ms:.3f} ms, NFP head + fc {head_ms:.3f} ms "
              f"(median of 20, CUDA events)")
    return launches


def serve_mobilenetv3(Predictor, nfp_small_cuda, nfp_large_cuda, gap2d, nfp):
    """This slice's main path: MobileNetV3 + multi_stage_nfp; returns its
    launches of each kernel."""
    kw = dict(model_type="mobilenetv3", model_variant="multi_stage_nfp", num_classes=21,
              batch_size=32, input_size=224)
    t0 = time.perf_counter()
    pred = Predictor(**kw, device="cuda")
    print(f"serve mobilenetv3: Predictor(mobilenetv3, multi_stage_nfp, 21 classes, "
          f"batch_size=32, 224 px) on cuda in {time.perf_counter() - t0:.2f} s")
    requests = requests_of(np.random.default_rng(2))
    pred.predict(requests[0])  # warm-up

    nfp_small_cuda.launches = nfp_large_cuda.launches = 0
    outs, lat = answer(pred, requests, "serve mobilenetv3")
    launches = dict(nfp_small=nfp_small_cuda.launches, nfp_large=nfp_large_cuda.launches)

    batches = sum(-(-len(r) // 32) for r in requests)
    want = dict(nfp_small=2 * batches, nfp_large=3 * batches)
    if launches != want:
        raise AssertionError(f"serve mobilenetv3: launches {launches}, expected {want} "
                             f"(3 x K2 and 2 x K1 per batch, {batches} batches)")
    print(f"serve mobilenetv3: requests of {[len(r) for r in requests]} images answered in "
          f"{[round(t * 1e3, 2) for t in lat]} ms; launches {launches} over {batches} batches")
    match_cpu(Predictor, pred, kw, [(pred.preprocess(r), o) for r, o in zip(requests, outs)],
              "serve mobilenetv3")

    gen = torch.Generator(device="cuda").manual_seed(3)
    model = pred.model

    def taps_and_head(feats, head):
        sims = torch.cat([nfp(f, 1, "cosine", padding=1, fuse_gap=True) for f in feats], dim=1)
        return model.fc(gap2d(head) * model.nfp_proj(sims))

    for b in (32, 128):
        x = torch.randn((b, 224, 224, 3), generator=gen, device="cuda")
        with torch.inference_mode():
            feats, head = model.backbone(x, mode="features+head")
            ms = median_ms(lambda: model(x), runs=20)
            backbone_ms = median_ms(lambda: model.backbone(x, mode="features+head"), runs=20)
            nfp_ms = median_ms(lambda: taps_and_head(feats, head), runs=20)
            busy, n_kernels, top = device_profile(lambda: model(x))
        print(f"serve mobilenetv3: forward B={b} fp32 {ms:.3f} ms/batch = "
              f"{b / ms * 1e3:.1f} img/s; backbone (features+head) {backbone_ms:.3f} ms, "
              f"five NFP taps + projections + fc {nfp_ms:.3f} ms (median of 20, CUDA events)")
        if not n_kernels:
            print(f"serve mobilenetv3: forward B={b} torch.profiler recorded no device "
                  f"events: device time not measured")
            continue
        print(f"serve mobilenetv3: forward B={b} torch.profiler: {n_kernels:.0f} kernels, "
              f"{busy:.3f} ms of device time per forward ({1 - busy / ms:.1%} of the "
              f"{ms:.3f} ms forward idle); most time: "
              + "; ".join(f"{n[:60]} {t:.3f} ms" for n, t in top))
    return launches


def other_mobilenetv3_variants(Predictor, nfp_small_cuda, nfp_large_cuda):
    """One batch of 8 of each other MobileNetV3 variant on the card against
    the CPU, with each variant's launch counts."""
    x = np.random.default_rng(4).standard_normal((8, 224, 224, 3)).astype(np.float32)
    for variant in MNV3_VARIANTS:
        if variant == "multi_stage_nfp":
            continue
        kw = dict(model_type="mobilenetv3", model_variant=variant, num_classes=21,
                  batch_size=8, input_size=224)
        pred = Predictor(**kw, device="cuda")
        nfp_small_cuda.launches = nfp_large_cuda.launches = 0
        out = pred.predict(x, preprocessed=True)
        got = (nfp_large_cuda.launches, nfp_small_cuda.launches)
        if got != MNV3_LAUNCHES[variant]:
            raise AssertionError(f"mobilenetv3/{variant}: (K2, K1) launches {got}, "
                                 f"expected {MNV3_LAUNCHES[variant]}")
        print(f"variant mobilenetv3/{variant}: K2 launches {got[0]}, K1 launches {got[1]}")
        match_cpu(Predictor, pred, kw, [(x, out)], f"variant mobilenetv3/{variant}")


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py needs a CUDA device and none is available")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from neighbour_feature_pooling_tpu_torch.ops import _build
    from neighbour_feature_pooling_tpu_torch.ops.neighborhood import (
        nfp_output_size, nfp_reference, num_neighbors)
    from neighbour_feature_pooling_tpu_torch.models.heads import gap2d
    from neighbour_feature_pooling_tpu_torch.ops.nfp_cuda import nfp, nfp_large_cuda, nfp_small_cuda
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

    print("kernels: nfp_small (K1) against nfp_reference on the card "
          "(fp32 rtol=atol=1e-5; bf16 within one bf16 ulp)")
    rows = dict(nfp_small=check_kernel(nfp_small_cuda, k1_cases(), "serve B=32 float32 fuse_gap=True",
                                       nfp_reference, num_neighbors, nfp_output_size))
    print("kernels: nfp_large (K2) against nfp_reference on the card "
          "(fp32 rtol=atol=1e-5; bf16 within one bf16 ulp)")
    rows["nfp_large"] = check_kernel(nfp_large_cuda, k2_cases(), K2_MAIN,
                                     nfp_reference, num_neighbors, nfp_output_size)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"serve: torch.backends.cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"torch.backends.cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    per_path = [serve_resnet18(Predictor, nfp_small_cuda, nfp_large_cuda),
                serve_mobilenetv3(Predictor, nfp_small_cuda, nfp_large_cuda, gap2d, nfp)]
    other_mobilenetv3_variants(Predictor, nfp_small_cuda, nfp_large_cuda)
    launches = {k: sum(p[k] for p in per_path) for k in rows}

    sources = dict(nfp_small=("neighbour_feature_pooling_tpu_torch/csrc/nfp_small.cu",
                              "neighbour_feature_pooling_tpu/ops/nfp_pallas.py:69"),
                   nfp_large=("neighbour_feature_pooling_tpu_torch/csrc/nfp_large.cu",
                              "neighbour_feature_pooling_tpu/ops/nfp_pallas.py:156"))
    print(json.dumps({"kernels": [dict(
        name=k, route="cuda", source=sources[k][0], replaces=sources[k][1],
        launches=launches[k], library_ms=None, **rows[k]) for k in rows]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
