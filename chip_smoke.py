#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; one CUDA card, nvcc
    python3 chip_smoke.py --parent DIR   # also time DIR's K1, K2 and K3 (another checkout) beside this one's

Drives ``neighbour_feature_pooling_tpu_torch`` (never JAX) on the card:

1. card: the device name and ``nvidia-smi``'s name and power limit;
2. build: compiles every kernel in ``csrc/`` with nvcc for sm_90a, one
   nvcc per source, all at once;
3. kernels: holds each kernel against its plain PyTorch version on the card
   at the main paths' shapes and a spread of measures and geometries, and
   times both (CUDA events, median of 50 runs queued behind a GPU sleep, so
   host launch overhead is not timed), beside the least time the card could
   take (bytes at 3.35 TB/s or fp32 operations at 67 TFLOP/s, whichever is
   larger): K1 (``nfp_small``, each line with its plan: rows per tile, lanes
   per pair G, channels per staged chunk), K2 (``nfp_large``, each line with
   its plan: rows per block, rows per step, columns per tile, lanes per
   position G, channels per staged chunk, staged pixel stride in 16-byte
   vectors) and
   K3 (``nfp_strip``, K2's kernel template with ``pearson`` added, each line
   with the same plan fields); with ``--parent``, each K1, K2 and K3 line
   also gives the other checkout's time on the same input, in turns
   (parent, this, this, parent), and its ptxas lines are printed;
4. serve ResNet18: a ResNet18 + texture_nfp ``Predictor`` on the card with
   seeded weights answers three requests (1, 32, 45 images), goes through
   K1 once per batch, and matches a CPU ``Predictor`` with the same weights
   (TF32 off); then the forward rate at B=32 and B=128;
5. serve MobileNetV3: the same for MobileNetV3-Large + multi_stage_nfp,
   which runs K2 on the 112², 56² and 28² taps and K1 on the 14² and 7²
   ones (3 and 2 launches per batch), with the forward split into the
   backbone and the NFP taps + projections + fc;
6. the other MobileNetV3 variants: one batch each on the card against the
   CPU, with each one's launch counts;
7. int8 kernels: K4 (``int8_gemm``) and K5 (``int8_conv``) against their
   plain versions on the card, bit for bit (``torch.equal``), at every
   ResNet18 shape of int8 serving at B=32 and some at B=128, on ragged
   shapes that reach both tile sizes and the 16-byte, 4-byte and byte
   paths of A, in the s32, fused fp32 and s8 + ReLU forms, with the weight
   packed once (as the model does; what the times are of) and packed in
   the call; times beside the
   bound (bytes at 3.35 TB/s or int8 operations at 1,979 TOPS), K4 beside
   ``torch._int_mm`` (cuBLASLt s8, a yardstick the port never calls), K5
   beside a cuDNN fp32 conv with TF32 off (context only);
8. serve ResNet18 int8: an int8 ResNet18 + texture_nfp ``Predictor``
   answers the three requests with 17 K5, 3 K4 and 1 K1 launches per
   batch and matches a CPU int8 ``Predictor``; then ``calibrate`` on 64
   images, the same again with 8 of the K5 launches emitting s8, against
   a CPU ``Predictor`` given the card's scales and chains; forward times
   at B=32 and B=128, dynamic and calibrated, beside fp32 and the host's
   time to enqueue a forward, and a torch.profiler split;
9. kernel entry: the port's bench tool
   (``tools/bench_nfp_kernel.py``) in-process through ``ops.nfp_kernel``,
   the counterpart of the JAX ``nfp_pallas``, at its four shapes, fused and
   not, with ``cosine`` (K2) and ``pearson`` (K3), plus one 16x16 map (K1);
   the launch counters show each route, every output is held against the
   plain version, and kernel and plain times are printed per shape beside
   the bound;
10. train: (a) one train step (``train.engine.train_step``) of ResNet18 +
   texture_nfp (21 classes, 224 px, B=8, fp32, TF32 off) on the card and on
   the CPU from the same seeded weights and batch: loss within 1e-4, the
   heads' gradients within 1e-4 of each tensor's largest magnitude, the new
   BatchNorm running statistics within 1e-5, every gradient against a CPU
   fp64 step no further off (largest and median tensor) than twice the CPU
   fp32 step's own error (``train_parity`` says why), and K1 launched once
   by the step (the NFP backward launches nothing: it differentiates the
   plain version); the same for MobileNetV3-Large + multi_stage_nfp (K2
   three times, K1 twice); (b) the train-step rate at B=32 and B=128 on batches
   resident on the card (median of 20 steps after 3, CUDA events), the
   peak memory, the step split into forward, backward and optimizer, the
   NFP backward alone, and a torch.profiler device-busy share and kernels
   per step; (c) the CLI, ``cli.main`` on synthetic data at 224 px, B=32,
   one epoch, in a temporary directory, then a ``Predictor`` serving one
   request from the run's ``best`` checkpoint.

Any failure raises and the exit code is non-zero. The last two lines are a
JSON record of each kernel and the ``{"ok": true, ...}`` line.
"""

import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
FP32_FLOPS_PER_S = 67e12   # H100 SXM fp32, outside the tensor cores
INT8_OPS_PER_S = 1979e12   # H100 SXM int8 tensor cores, dense
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
    CUDA events, queued behind a GPU sleep (``tools/common.py``)."""
    from neighbour_feature_pooling_tpu_torch.tools.common import median_ms as timed
    return timed(fn, runs, warmup=3)


def bound_ms(n_bytes, n_flops):
    """The least time the card could take for work that moves ``n_bytes``
    and does ``n_flops`` fp32 operations: the larger of bytes at 3.35 TB/s
    and operations at 67 TFLOP/s, in ms, and which of the two it is."""
    bytes_ms, flops_ms = n_bytes / HBM_BYTES_PER_S * 1e3, n_flops / FP32_FLOPS_PER_S * 1e3
    return max(bytes_ms, flops_ms), "bytes" if bytes_ms >= flops_ms else "operations"


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
        ("single-image request B=1", (1, 7, 7, 512), torch.float32, "cosine",
         dict(padding=1, fuse_gap=True)),
        ("mnv3 tap 4 B=128", (128, 14, 14, 112), torch.float32, "cosine",
         dict(padding=1, fuse_gap=True)),
        ("mnv3 tap 5 B=128", (128, 7, 7, 960), torch.float32, "cosine",
         dict(padding=1, fuse_gap=True)),
        ("mnv3 tap 5 B=32 bfloat16", (32, 7, 7, 960), torch.bfloat16, "cosine",
         dict(padding=1, fuse_gap=True)),
        ("resnet50 head, chunked C", (8, 7, 7, 2048), torch.float32, "cosine",
         dict(padding=1, fuse_gap=True)),
        ("resnet50 head map, chunked C", (8, 7, 7, 2048), torch.float32, "cosine",
         dict(padding=1)),
        ("resnet50 head pearson, chunked C", (8, 7, 7, 2048), torch.float32, "pearson",
         dict(padding=1, fuse_gap=True)),
        ("R=2 dilation=2 C=768, chunked, 24 neighbours", (8, 14, 14, 768), torch.float32,
         "cosine", dict(radius=2, dilation=2, padding=4, fuse_gap=True)),
        ("odd 13x11 zeros pad 2, ragged last tile", (4, 13, 11, 64), torch.float32, "cosine",
         dict(padding=2, padding_mode="zeros", fuse_gap=True)),
        ("odd 13x11 zeros pad 2 map", (4, 13, 11, 64), torch.float32, "cosine",
         dict(padding=2, padding_mode="zeros")),
        ("pearson 16x16, 256 positions", (8, 16, 16, 64), torch.float32, "pearson",
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
        ("tap 1 B=1 float32", (1, 112, 112, 16), torch.float32, "cosine", gap),
        ("tap 1 B=128 float32", (128, 112, 112, 16), torch.float32, "cosine", gap),
        ("tap 2 B=128 float32", (128, 56, 56, 24), torch.float32, "cosine", gap),
        ("tap 3 B=128 float32", (128, 28, 28, 40), torch.float32, "cosine", gap),
        ("nfp_insert map, padding 0", (32, 56, 56, 24), torch.float32, "cosine",
         dict(padding=0)),
    ]
    for dtype in (torch.float32, torch.bfloat16):
        for tap, (s, c) in enumerate(((112, 16), (56, 24), (28, 40)), start=1):
            if dtype == torch.float32 or tap > 1:
                cases.append((f"tap {tap} B=32 {str(dtype)[6:]} map", (32, s, s, c), dtype,
                              "cosine", dict(padding=1)))
    cases += [
        ("C=256 map, chunked C", (8, 56, 56, 256), torch.float32, "cosine", dict(padding=1)),
        ("smith map (pixel sums)", (8, 56, 56, 24), torch.float32, "smith", dict(padding=1)),
        ("scs p=2.0 map (pixel sums)", (8, 56, 56, 24), torch.float32, "scs",
         dict(padding=1, p=2.0)),
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


def check_kernel(wrapper, cases, main_label, nfp_reference, num_neighbors, nfp_output_size,
                 note=None, parent=None):
    """Every case against the plain version; returns the main-path case's row.
    A case's kwargs may add ``offset`` (added to the random input) and
    ``constant`` (one random pixel repeated over the whole map).
    ``note(shape, dtype, measure, radius, kw)`` adds text to a case's line; ``parent``,
    the same wrapper from another checkout, is timed beside the kernel on the
    same input, in turns (parent, kernel, kernel, parent)."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    main_row = None
    warm = False
    for label, shape, dtype, measure, kw in cases:
        kw = dict(kw)
        radius = kw.pop("radius", 1)
        offset, constant = kw.pop("offset", 0.0), kw.pop("constant", False)
        if constant:
            pixel = torch.randn((shape[0], 1, 1, shape[3]), generator=gen, device="cuda")
            x = pixel.expand(shape).contiguous().to(dtype)
        else:
            x = (torch.randn(shape, generator=gen, device="cuda") + offset).to(dtype)
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
        if not warm:  # the process's first timing reads high; keep none of it
            median_ms(lambda: wrapper(x, radius, measure, **kw))
            warm = True
        if parent is not None:
            parent_ms = [median_ms(lambda: parent(x, radius, measure, **kw))]
        k_ms = median_ms(lambda: wrapper(x, radius, measure, **kw))
        if parent is not None:
            k2_ms = median_ms(lambda: wrapper(x, radius, measure, **kw))
            parent_ms.append(median_ms(lambda: parent(x, radius, measure, **kw)))
        p_ms = median_ms(lambda: nfp_reference(x, radius, measure, **kw))
        b, h, w, c = shape
        pad, dil = kw.get("padding", 0), kw.get("dilation", 1)
        positions = (nfp_output_size(h, radius, 1, pad, dil)
                     * nfp_output_size(w, radius, 1, pad, dil))
        n_bytes = x.numel() * x.element_size() + out.numel() * out.element_size()
        n_flops = b * positions * num_neighbors(radius) * c * FLOPS_PER_TERM[measure]
        bound, bound_by = bound_ms(n_bytes, n_flops)
        row = dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=bound, bound_by=bound_by)
        extra = "" if note is None else "  " + note(shape, dtype, measure, radius, kw)
        if parent is not None:
            extra += (f"  parent {parent_ms[0] * 1e3:.2f} / {parent_ms[1] * 1e3:.2f} us, "
                      f"kernel again {k2_ms * 1e3:.2f} us")
        print(f"  {label:42s} {str(tuple(shape)):18s} max|err| {err:.3e}  kernel {k_ms * 1e3:9.2f} us"
              f"  plain {p_ms * 1e3:9.2f} us  bound {row['bound_ms'] * 1e3:6.2f} us ({row['bound_by']})"
              + extra)
        if label == main_label:
            main_row = row
    return main_row


K3_MAIN = "tap 1 B=32 float32 pearson"


def k3_cases():
    """(label, shape, dtype, measure, kwargs) for the strip kernel K3: maps
    above 256 positions, ``pearson`` (the measure ``nfp_kernel`` sends it)
    at the bench shapes, one and 128 images, chunked channels and geometry
    corners, then other stat-free measures run on K3 directly."""
    gap, pad1 = dict(padding=1, fuse_gap=True), dict(padding=1)
    tap1, mid = (32, 112, 112, 16), (8, 56, 56, 24)
    cases = [
        (K3_MAIN, tap1, torch.float32, "pearson", gap),
        ("tap 1 B=32 float32 pearson map", tap1, torch.float32, "pearson", pad1),
        ("tap 1 B=1 float32 pearson", (1, 112, 112, 16), torch.float32, "pearson", gap),
        ("tap 1 B=128 float32 pearson", (128, 112, 112, 16), torch.float32, "pearson", gap),
        ("C=256 pearson, chunked C", (8, 56, 56, 256), torch.float32, "pearson", gap),
        ("C=256 pearson map, chunked C", (8, 56, 56, 256), torch.float32, "pearson", pad1),
        ("C=512 bfloat16 pearson, chunked C", (4, 56, 56, 512), torch.bfloat16, "pearson",
         gap),
        ("C=270 pearson map, scalar loads, chunked C", (4, 56, 56, 270), torch.float32,
         "pearson", pad1),
        ("resnet_layer1 pearson", (16, 56, 56, 64), torch.float32, "pearson", gap),
        ("resnet_layer1 pearson map", (16, 56, 56, 64), torch.float32, "pearson", pad1),
        ("pearson similarity=False", mid, torch.float32, "pearson",
         dict(gap, similarity=False)),
        ("tap 2 B=32 bfloat16 pearson", (32, 56, 56, 24), torch.bfloat16, "pearson", gap),
        ("tap 2 B=32 bfloat16 pearson map", (32, 56, 56, 24), torch.bfloat16, "pearson", pad1),
        ("pearson R=2 dilation=2", mid, torch.float32, "pearson",
         dict(radius=2, dilation=2, padding=4, fuse_gap=True)),
        ("pearson odd 57x43", (8, 57, 43, 24), torch.float32, "pearson", gap),
    ]
    for mode in ("zeros", "reflect", "replicate", "circular"):
        cases.append((f"pearson {mode} pad 2 map", mid, torch.float32, "pearson",
                      dict(padding=2, padding_mode=mode)))
    cases += [
        ("pearson C=30 scalar loads", (8, 56, 56, 30), torch.float32, "pearson", gap),
        ("pearson input offset +3", mid, torch.float32, "pearson", dict(gap, offset=3.0)),
        ("pearson constant map, zeros pad", mid, torch.float32, "pearson",
         dict(padding=1, padding_mode="zeros", constant=True)),
    ]
    for measure, kw in (("cosine", {}), ("norm", dict(p=3.0)), ("smith", {}), ("jeffrey", {}),
                        ("scs", dict(p=2.0)), ("attention", {})):
        kw = dict(gap, **kw)
        label = measure + "".join(f" {k}={v}" for k, v in kw.items() if k != "padding")
        cases.append((label, mid, torch.float32, measure, kw))
    return cases


def device_profile(fn, steps=5):
    """Device time per call of ``fn`` summed over its kernels, kernels per
    call, and the device ms per call of each kernel name, from a
    ``torch.profiler`` trace of ``steps`` calls."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    # a user annotation's device span (Optimizer.step, say) overlaps its kernels
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total / 1e3 / steps
    return sum(by_name.values()), len(kernels) / steps, by_name


def top3(by_name):
    return "; ".join(f"{n[:60]} {t:.3f} ms"
                     for n, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:3])


def requests_of(rng):
    return [[rng.random((int(rng.integers(180, 361)), int(rng.integers(180, 361)), 3),
                        dtype=np.float32) for _ in range(n)] for n in (1, 32, 45)]


def match_cpu(Predictor, pred, kw, batches, tag, setup=None):
    """The card's answers against a CPU Predictor with the same weights
    (``setup(cpu)`` first, when given): labels equal and max |dprob| <=
    1e-4. ``batches`` are (preprocessed images, the card's output) pairs."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "weights.pt")
        torch.save(pred.state_dict(), path)
        cpu = Predictor(**kw, checkpoint=path, device="cpu")
    if setup is not None:
        setup(cpu)
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


class Launches:
    """The launch counters of the kernel wrappers, by kernel name."""

    def __init__(self, **wrappers):
        self.wrappers = wrappers

    def reset(self):
        for w in self.wrappers.values():
            w.launches = 0
        self.wrappers["int8_conv"].s8_launches = 0

    def read(self):
        return {k: w.launches for k, w in self.wrappers.items()}

    def s8(self):
        return self.wrappers["int8_conv"].s8_launches


def serve_resnet18(Predictor, launches):
    """The first slice's main path; returns its launches of each kernel."""
    kw = dict(model_type="resnet18", model_variant="texture_nfp", num_classes=21,
              batch_size=32, input_size=224)
    t0 = time.perf_counter()
    pred = Predictor(**kw, device="cuda")
    print(f"serve resnet18: Predictor(resnet18, texture_nfp, 21 classes, batch_size=32, "
          f"224 px) on cuda in {time.perf_counter() - t0:.2f} s")
    requests = requests_of(np.random.default_rng(0))
    pred.predict(requests[0])  # warm-up: cuDNN plans, first launches

    launches.reset()
    outs, lat = answer(pred, requests, "serve resnet18")
    counts = launches.read()

    expected = sum(-(-len(r) // 32) for r in requests)
    if counts != dict(nfp_small=expected, nfp_large=0, nfp_strip=0, int8_gemm=0, int8_conv=0):
        raise AssertionError(f"serve resnet18: launches {counts}, expected "
                             f"nfp_small {expected} (= batches) and no other")
    pre = []
    for req in requests:
        t0 = time.perf_counter()
        pred.preprocess(req)
        pre.append(time.perf_counter() - t0)
    print(f"serve resnet18: requests of {[len(r) for r in requests]} images answered in "
          f"{[round(t * 1e3, 2) for t in lat]} ms, of which host preprocessing "
          f"{[round(t * 1e3, 2) for t in pre]} ms; launches {counts}")
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
            busy, n_kernels, by_name = device_profile(lambda: model(x))
        print(f"serve resnet18: forward B={b} fp32 {ms:.3f} ms/batch = {b / ms * 1e3:.1f} img/s; "
              f"backbone {backbone_ms:.3f} ms, NFP head + fc {head_ms:.3f} ms "
              f"(median of 20, CUDA events)")
        if not n_kernels:
            print(f"serve resnet18: forward B={b} torch.profiler recorded no device events: "
                  f"device time not measured")
            continue
        print(f"serve resnet18: forward B={b} torch.profiler: {n_kernels:.0f} kernels, "
              f"{busy:.3f} ms of device time per forward ({1 - busy / ms:.1%} of the "
              f"{ms:.3f} ms forward idle); most time: " + top3(by_name))
    return counts


def serve_mobilenetv3(Predictor, launches, gap2d, nfp):
    """The second slice's main path: MobileNetV3 + multi_stage_nfp; returns its
    launches of each kernel."""
    kw = dict(model_type="mobilenetv3", model_variant="multi_stage_nfp", num_classes=21,
              batch_size=32, input_size=224)
    t0 = time.perf_counter()
    pred = Predictor(**kw, device="cuda")
    print(f"serve mobilenetv3: Predictor(mobilenetv3, multi_stage_nfp, 21 classes, "
          f"batch_size=32, 224 px) on cuda in {time.perf_counter() - t0:.2f} s")
    requests = requests_of(np.random.default_rng(2))
    pred.predict(requests[0])  # warm-up

    launches.reset()
    outs, lat = answer(pred, requests, "serve mobilenetv3")
    counts = launches.read()

    batches = sum(-(-len(r) // 32) for r in requests)
    want = dict(nfp_small=2 * batches, nfp_large=3 * batches, nfp_strip=0, int8_gemm=0,
                int8_conv=0)
    if counts != want:
        raise AssertionError(f"serve mobilenetv3: launches {counts}, expected {want} "
                             f"(3 x K2 and 2 x K1 per batch, {batches} batches)")
    print(f"serve mobilenetv3: requests of {[len(r) for r in requests]} images answered in "
          f"{[round(t * 1e3, 2) for t in lat]} ms; launches {counts} over {batches} batches")
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
            busy, n_kernels, by_name = device_profile(lambda: model(x))
        print(f"serve mobilenetv3: forward B={b} fp32 {ms:.3f} ms/batch = "
              f"{b / ms * 1e3:.1f} img/s; backbone (features+head) {backbone_ms:.3f} ms, "
              f"five NFP taps + projections + fc {nfp_ms:.3f} ms (median of 20, CUDA events)")
        if not n_kernels:
            print(f"serve mobilenetv3: forward B={b} torch.profiler recorded no device "
                  f"events: device time not measured")
            continue
        print(f"serve mobilenetv3: forward B={b} torch.profiler: {n_kernels:.0f} kernels, "
              f"{busy:.3f} ms of device time per forward ({1 - busy / ms:.1%} of the "
              f"{ms:.3f} ms forward idle); most time: " + top3(by_name))
    return counts


def other_mobilenetv3_variants(Predictor, launches):
    """One batch of 8 of each other MobileNetV3 variant on the card against
    the CPU, with each variant's launch counts."""
    x = np.random.default_rng(4).standard_normal((8, 224, 224, 3)).astype(np.float32)
    for variant in MNV3_VARIANTS:
        if variant == "multi_stage_nfp":
            continue
        kw = dict(model_type="mobilenetv3", model_variant=variant, num_classes=21,
                  batch_size=8, input_size=224)
        pred = Predictor(**kw, device="cuda")
        launches.reset()
        out = pred.predict(x, preprocessed=True)
        counts = launches.read()
        got = (counts["nfp_large"], counts["nfp_small"])
        if got != MNV3_LAUNCHES[variant]:
            raise AssertionError(f"mobilenetv3/{variant}: (K2, K1) launches {got}, "
                                 f"expected {MNV3_LAUNCHES[variant]}")
        print(f"variant mobilenetv3/{variant}: K2 launches {got[0]}, K1 launches {got[1]}")
        match_cpu(Predictor, pred, kw, [(x, out)], f"variant mobilenetv3/{variant}")


#: K4 cases: (label, M, K, N, forms); the ResNet18 downsample GEMMs at 224 px
K4_MAIN = "layer2 downsample B=32 fp32"
K4_SHAPES = [("layer2 downsample B=32", 25088, 64, 128), ("layer3 downsample B=32", 6272, 128, 256),
             ("layer4 downsample B=32", 1568, 256, 512), ("layer2 downsample B=128", 100352, 64, 128),
             ("layer3 downsample B=128", 25088, 128, 256), ("layer4 downsample B=128", 6272, 256, 512),
             ("ragged M, K, N", 1000, 100, 70), ("ragged, tiny", 37, 300, 9),
             ("ragged, K 37 (byte path)", 200, 37, 24)]
#: output forms: (label, with scale and bias, out dtype, relu)
INT8_FORMS = [("s32", False, torch.int32, False), ("fp32", True, torch.float32, False),
              ("s8 relu", True, torch.int8, True)]
#: K5 cases: (label, x shape, (kh, kw, cout), padding, strides, forms)
K5_MAIN = "layer1 3x3 B=32 fp32"
K5_SHAPES = [
    ("stem 7x7/2 B=32", (32, 224, 224, 3), (7, 7, 64), ((3, 3), (3, 3)), (2, 2)),
    ("layer1 3x3 B=32", (32, 56, 56, 64), (3, 3, 64), ((1, 1), (1, 1)), (1, 1)),
    ("layer2.0 3x3/2 B=32", (32, 56, 56, 64), (3, 3, 128), ((1, 1), (1, 1)), (2, 2)),
    ("layer2 3x3 B=32", (32, 28, 28, 128), (3, 3, 128), ((1, 1), (1, 1)), (1, 1)),
    ("layer3.0 3x3/2 B=32", (32, 28, 28, 128), (3, 3, 256), ((1, 1), (1, 1)), (2, 2)),
    ("layer3 3x3 B=32", (32, 14, 14, 256), (3, 3, 256), ((1, 1), (1, 1)), (1, 1)),
    ("layer4.0 3x3/2 B=32", (32, 14, 14, 256), (3, 3, 512), ((1, 1), (1, 1)), (2, 2)),
    ("layer4 3x3 B=32", (32, 7, 7, 512), (3, 3, 512), ((1, 1), (1, 1)), (1, 1)),
    ("layer1 3x3 B=128", (128, 56, 56, 64), (3, 3, 64), ((1, 1), (1, 1)), (1, 1)),
    ("5x5 asymmetric pads, Cin 24, Cout 40", (3, 29, 23, 24), (5, 5, 40), ((2, 1), (0, 3)), (2, 1)),
    ("3x3 SAME, Cin 16, Cout 70, odd map", (2, 15, 13, 16), (3, 3, 70), "SAME", (1, 1)),
    ("3x3 Cin 16 (K 144), M 1210", (10, 11, 11, 16), (3, 3, 32), ((1, 1), (1, 1)), (1, 1)),
    ("3x3 Cin 16, M 50000, Cout 70 (large tile)", (5, 100, 100, 16), (3, 3, 70), "SAME", (1, 1)),
    ("5x5/2 Cin 3, asymmetric pads", (3, 37, 41, 3), (5, 5, 24), ((2, 1), (0, 3)), (2, 2)),
    ("3x3 Cin 5 (byte path)", (2, 17, 19, 5), (3, 3, 40), "SAME", (1, 1)),
]
#: the forms each case runs in: every form where the main path emits it or
#: the case is ragged, else the main path's fp32 form
K4_FP32_ONLY = {"layer3 downsample B=32", "layer2 downsample B=128", "layer3 downsample B=128",
                "layer4 downsample B=128"}
K5_FP32_ONLY = {"layer2 3x3 B=32", "layer3.0 3x3/2 B=32", "layer3 3x3 B=32",
                "layer4.0 3x3/2 B=32", "layer1 3x3 B=128"}
#: the K5 weights whose pack in the call is timed beside the pack once
K5_PACK_TIMED = {"layer1 3x3 B=32", "layer4 3x3 B=32"}


def _forms(fp32_only, label):
    return INT8_FORMS[1:2] if label in fp32_only else INT8_FORMS


def _int_mm_ms(a, b):
    """``torch._int_mm`` (cuBLASLt s8 × s8 → s32) on the operands, row- or
    else column-major B; None (with the reason) where it refuses them."""
    for bb in (b, b.t().contiguous().t()):
        try:
            torch._int_mm(a, bb)
        except RuntimeError as e:
            err = str(e).splitlines()[0]
            continue
        return median_ms(lambda: torch._int_mm(a, bb)), None
    return None, err


def check_int8_kernels(int8_gemm, int8_gemm_reference, pack_weight,
                       int8_conv2d, int8_conv2d_reference, pack_conv_weight):
    """K4 and K5 against their plain versions on the card, bit for bit,
    with times and bounds; returns each kernel's main-path row. The weight
    is packed once per case, as the int8 modules pack theirs; each case is
    also run once with the pack in the call."""
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(5)

    def s8(shape):
        return torch.randint(-127, 128, shape, generator=gen, device="cuda", dtype=torch.int8)

    def epilogue(n, with_scale):
        if not with_scale:
            return {}
        return dict(scale=torch.rand(n, generator=gen, device="cuda") * 5e-3 + 1e-4,
                    bias=torch.rand(n, generator=gen, device="cuda") * 4 - 2)

    def check(label, kernel, packing, plain, n_ops, in_bytes, out_numel):
        out = kernel()
        if not torch.equal(out, kernel()):
            raise AssertionError(f"{label}: two launches on the same input differ")
        if not torch.equal(out, packing()):
            raise AssertionError(f"{label}: packing the weight in the call changes the result")
        torch.cuda.synchronize()
        ref = plain()
        if out.dtype != ref.dtype or out.shape != ref.shape or not torch.equal(out, ref):
            err = (out.double() - ref.double()).abs().max().item() if out.shape == ref.shape else None
            raise AssertionError(f"{label}: kernel {tuple(out.shape)} {out.dtype} differs from "
                                 f"the plain version {tuple(ref.shape)} {ref.dtype} (max |err| {err})")
        k_ms, p_ms = median_ms(kernel), median_ms(plain)
        n_bytes = in_bytes + out_numel * out.element_size()
        bytes_ms, ops_ms = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / INT8_OPS_PER_S * 1e3
        row = dict(max_abs_err=0.0, ms=k_ms, plain_ms=p_ms, bound_ms=max(bytes_ms, ops_ms),
                   bound_by="bytes" if bytes_ms >= ops_ms else "operations")
        print(f"  {label:52s} kernel {k_ms * 1e3:9.2f} us  plain {p_ms * 1e3:9.2f} us  "
              f"bound {row['bound_ms'] * 1e3:7.2f} us ({row['bound_by']}), equal")
        return row

    rows = {}
    print("kernels: int8_gemm (K4) against int8_gemm_reference on the card (torch.equal)")
    for label, m, k, n in K4_SHAPES:
        a, b = s8((m, k)), s8((k, n))
        bp = pack_weight(b)
        for form, with_scale, out_dtype, relu in _forms(K4_FP32_ONLY, label):
            kw = dict(epilogue(n, with_scale), relu=relu)
            if with_scale:
                kw["out_dtype"] = out_dtype
            in_bytes = a.numel() + b.numel() + 8 * n * with_scale
            row = check(f"{label} {form} ({m},{k})x({k},{n})",
                        lambda: int8_gemm(a, b, b_packed=bp, **kw), lambda: int8_gemm(a, b, **kw),
                        lambda: int8_gemm_reference(a, b, **kw), 2 * m * n * k, in_bytes, m * n)
            if f"{label} {form}" == K4_MAIN:
                lib_ms, why = _int_mm_ms(a, b)
                s32_ms = median_ms(lambda: int8_gemm(a, b, b_packed=bp))
                print(f"  {label}: torch._int_mm (cuBLASLt s8 -> s32, no epilogue) "
                      + (f"{lib_ms * 1e3:.2f} us" if lib_ms is not None else f"refused: {why}")
                      + f"; K4 in its s32 form {s32_ms * 1e3:.2f} us")
                rows["int8_gemm"] = dict(row, library_ms=lib_ms)
    print("kernels: int8_conv (K5) against int8_conv2d_reference on the card (torch.equal)")
    for label, xshape, (kh, kw_, cout), padding, strides in K5_SHAPES:
        x, w = s8(xshape), s8((kh, kw_, xshape[3], cout))
        wp = pack_conv_weight(w)
        ho = wo = None
        for form, with_scale, out_dtype, relu in _forms(K5_FP32_ONLY, label):
            kw = dict(epilogue(cout, with_scale), relu=relu, padding=padding, strides=strides)
            if with_scale:
                kw["out_dtype"] = out_dtype
            out = int8_conv2d(x, w, w_packed=wp, **kw)
            _, ho, wo, _ = out.shape
            in_bytes = x.numel() + w.numel() + 8 * cout * with_scale
            row = check(f"{label} {form} {tuple(xshape)}*({kh},{kw_},{xshape[3]},{cout})/{strides[0]}",
                        lambda: int8_conv2d(x, w, w_packed=wp, **kw), lambda: int8_conv2d(x, w, **kw),
                        lambda: int8_conv2d_reference(x, w, **kw),
                        2 * out.shape[0] * ho * wo * cout * kh * kw_ * xshape[3], in_bytes, out.numel())
            if f"{label} {form}" == K5_MAIN:
                rows["int8_conv"] = dict(row, library_ms=None)
            if label in K5_PACK_TIMED and form == "fp32":
                pack_ms = median_ms(lambda: int8_conv2d(x, w, **kw))
                print(f"  {label}: with the {tuple(w.shape)} weight packed in the call "
                      f"{pack_ms * 1e3:.2f} us, packed once {row['ms'] * 1e3:.2f} us")
        if xshape[0] == 32 and padding != "SAME":
            xf = x.float().permute(0, 3, 1, 2)  # channels_last NCHW, as the fp32 model
            wf = w.float().permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
            cudnn_ms = median_ms(lambda: F.conv2d(xf, wf, stride=strides,
                                                  padding=(padding[0][0], padding[1][0])))
            print(f"  {label}: cuDNN fp32 conv at the same shape, TF32 off: {cudnn_ms * 1e3:.2f} us "
                  f"(context, not a yardstick: PyTorch has no int8 conv on CUDA)")
    return rows


def forward_ms(model, x, tag):
    """Forward ms at the batch of ``x`` (median of 20, CUDA events), beside
    the host's time to enqueue one forward (least of 5 runs of 3 forwards,
    few enough kernels to fit the launch queue, so the host never waits
    for the device inside a run): where that is the larger, the host sets
    the rate and the device idles."""
    with torch.inference_mode():
        ms = median_ms(lambda: model(x), runs=20)
        host_ms = float("inf")
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(3):
                model(x)
            host_ms = min(host_ms, (time.perf_counter() - t0) / 3 * 1e3)
        torch.cuda.synchronize()
    b = x.shape[0]
    print(f"{tag}: forward B={b} {ms:.3f} ms/batch = {b / ms * 1e3:.1f} img/s "
          f"(median of 20, CUDA events); host time to enqueue it {host_ms:.3f} ms")
    return ms


def serve_resnet18_int8(Predictor, launches):
    """The third slice's main path: int8 ResNet18 + texture_nfp, dynamic, then
    calibrated; returns its launches of each kernel."""
    kw = dict(model_type="resnet18", model_variant="texture_nfp", num_classes=21,
              batch_size=32, input_size=224, quantize="int8")
    t0 = time.perf_counter()
    pred = Predictor(**kw, device="cuda")
    print(f"serve resnet18 int8: Predictor(resnet18, texture_nfp, 21 classes, batch_size=32, "
          f"224 px, quantize='int8') on cuda in {time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(6)
    requests = requests_of(rng)
    batches = sum(-(-len(r) // 32) for r in requests)
    gen = torch.Generator(device="cuda").manual_seed(7)
    xs = {b: torch.randn((b, 224, 224, 3), generator=gen, device="cuda") for b in (32, 128)}
    fp32 = Predictor(**dict(kw, quantize=None), device="cuda").model
    total = {k: 0 for k in launches.wrappers}

    for tier in ("dynamic", "calibrated"):
        tag = f"serve resnet18 int8 {tier}"
        if tier == "calibrated":
            t0 = time.perf_counter()
            n_layers = pred.calibrate([rng.random((256, 256, 3), dtype=np.float32)
                                       for _ in range(64)])
            print(f"{tag}: calibrate() on 64 images: {n_layers} layers, "
                  f"{len(pred._int8_chains or {})} chains, in {time.perf_counter() - t0:.2f} s")
        pred.predict(requests[0])  # warm-up
        launches.reset()
        outs, lat = answer(pred, requests, tag)
        counts, s8 = launches.read(), launches.s8()
        want = dict(nfp_small=batches, nfp_large=0, nfp_strip=0, int8_gemm=3 * batches,
                    int8_conv=17 * batches)
        want_s8 = 8 * batches if tier == "calibrated" else 0
        if counts != want or s8 != want_s8:
            raise AssertionError(f"{tag}: launches {counts}, {s8} emitting s8; expected {want}, "
                                 f"{want_s8} emitting s8 (17 K5, 3 K4, 1 K1 per batch)")
        total = {k: total[k] + counts[k] for k in total}
        print(f"{tag}: requests of {[len(r) for r in requests]} images answered in "
              f"{[round(t * 1e3, 2) for t in lat]} ms; launches {counts}, {s8} K5 launches "
              f"emitting s8, over {batches} batches")

        def copy_calibration(cpu):
            cpu._act_scales, cpu._int8_chains = dict(pred._act_scales), dict(pred._int8_chains)
            cpu._rebuild()

        match_cpu(Predictor, pred, kw, [(pred.preprocess(r), o) for r, o in zip(requests, outs)],
                  tag, setup=copy_calibration if tier == "calibrated" else None)
        for b, x in xs.items():
            ms = forward_ms(pred.model, x, tag)
            if tier == "dynamic":
                forward_ms(fp32, x, "serve resnet18 fp32 (same run)")
            with torch.inference_mode():
                busy, n_kernels, by_name = device_profile(lambda: pred.model(x))
            if not n_kernels:
                print(f"{tag}: forward B={b} torch.profiler recorded no device events: "
                      f"device time not measured")
                continue
            k4 = sum(t for n, t in by_name.items() if "int8_gemm_kernel" in n)
            k5 = sum(t for n, t in by_name.items() if "int8_conv_kernel" in n)
            print(f"{tag}: forward B={b} torch.profiler: {n_kernels:.0f} kernels, {busy:.3f} ms "
                  f"of device time per forward ({1 - busy / ms:.1%} of the {ms:.3f} ms forward "
                  f"idle); K5 {k5:.3f} ms, K4 {k4:.3f} ms per forward; most time: "
                  + top3(by_name))
    return total


def kernel_entry(launches, bench, nfp_kernel, nfp_reference):
    """The fourth slice's main path: the port's bench tool through
    ``nfp_kernel`` at its four shapes, fused and not, with ``cosine`` (K2)
    and ``pearson`` (K3), and one 16x16 map (K1); returns its launches of
    each kernel. The counted run checks each output against the plain
    version (fp32 rtol = atol = 1e-5) once; the timing runs come after."""
    x16 = torch.randn((16, 16, 16, 64), generator=torch.Generator(device="cuda").manual_seed(8),
                      device="cuda")
    launches.reset()
    records = [r for m in ("cosine", "pearson") for r in bench.run(m, iters=0)]
    small = nfp_kernel(x16, 1, "pearson", padding=1)
    counts = launches.read()

    n = len(bench.SHAPES) * len(bench.FUSE_OPTS["both"])
    want = dict(nfp_small=1, nfp_large=n, nfp_strip=n, int8_gemm=0, int8_conv=0)
    routes = {m: sorted({r["route"] for r in records if r["measure"] == m})
              for m in ("cosine", "pearson")}
    if counts != want or routes != {"cosine": ["k2"], "pearson": ["k3"]}:
        raise AssertionError(f"kernel entry: launches {counts}, routes {routes}; expected {want}, "
                             f"cosine on k2, pearson on k3 and the 16x16 map on k1")
    torch.cuda.synchronize()
    if not torch.allclose(small, nfp_reference(x16, 1, "pearson", padding=1), rtol=1e-5, atol=1e-5):
        raise AssertionError("kernel entry: the 16x16 map disagrees with the plain version")
    worst = max(r["max_err"] for r in records)
    print(f"kernel entry: nfp_kernel launches {counts} over {len(records)} bench configurations "
          f"and one 16x16 map; all within rtol=atol=1e-5 of the plain version "
          f"(max |err| {worst:.3e})")
    for m in ("cosine", "pearson"):
        for r in bench.run(m, iters=RUNS):
            # R=1, padding 1: an H x W output map of 8 neighbours, fp32
            positions = r["B"] * r["H"] * r["W"]
            out_numel = 8 * (r["B"] if r["fuse_gap"] else positions)
            bound, bound_by = bound_ms(4 * (positions * r["C"] + out_numel),
                                       positions * 8 * r["C"] * FLOPS_PER_TERM[m])
            print(f"  {m:8s} {r['route']} {r['shape']:14s} ({r['B']},{r['H']},{r['W']},{r['C']}) "
                  f"fuse_gap={r['fuse_gap']!s:5s} kernel {r['kernel_ms'] * 1e3:9.2f} us  "
                  f"plain {r['plain_ms'] * 1e3:9.2f} us  bound {bound * 1e3:6.2f} us "
                  f"({bound_by})  max|err| {r['max_err']:.3e}")
    return counts


def _events_ms(fn, runs=20, warmup=3):
    """Median wall time of ``fn`` on the card in ms: CUDA events around each
    of ``runs`` calls after ``warmup`` (one sync at the end, so the host's
    launch time shows wherever it holds the card back)."""
    for _ in range(warmup):
        fn()
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(runs)]
    for start, end in pairs:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in pairs]))


#: the heads' parameters: no BatchNorm or ReLU stands between them and the
#: loss, so their gradients are well conditioned in fp32
HEAD_PARAMS = ("fc.", "pool.nfp_proj.", "nfp_proj.")


def _grad_errors(grads, exact):
    """Per tensor, max |g - exact| over max |exact|, the latter floored at
    1e-6 of the largest |exact| of all tensors: a bias that feeds a
    train-mode BatchNorm has a gradient of exactly zero, which fp32 reads
    as rounding noise."""
    floor = 1e-6 * max(float(v.abs().max()) for v in exact.values())
    return {n: float((g.double() - exact[n]).abs().max()) / max(float(exact[n].abs().max()),
                                                                floor)
            for n, g in grads.items()}


def train_parity(launches, engine, get_model, model_type, variant, want):
    """One train step on the card, on the CPU in fp32 and on the CPU in fp64
    from the same seeded weights and batch (21 classes, 224 px, B=8): the
    loss, the new BatchNorm running statistics and the head's gradients of
    the card against the CPU's fp32 step; the gradients of every tensor of
    the card and of the CPU's fp32 step against the fp64 step; and the
    step's kernel launches. Returns the launches.

    Why the fp64 step: at 224 px the backbone's gradients are not
    computable to 1e-4 in fp32 on either device (a ReLU mask that flips
    on one rounding, BatchNorm's cancellations in the backward): the
    CPU's own fp32 step is up to a few 1e-2 of a tensor's largest
    gradient off its fp64 step. So the card is held to the CPU's fp32
    accuracy: over all tensors, the largest and the median error against
    the fp64 step at most twice the CPU's fp32 step's."""
    tag = f"train parity {model_type} + {variant}"
    states = {}
    for dev, dtype in (("cpu", torch.float32), ("cuda", torch.float32), ("fp64", torch.float64)):
        model = get_model(model_type, variant, 21).to(device="cpu" if dev == "fp64" else dev,
                                                      memory_format=torch.channels_last)
        states[dev] = engine.create_train_state(model, 11, 1e-3)
        model.to(dtype)
    rng = np.random.default_rng(12)
    host = {"image": torch.from_numpy(rng.standard_normal((8, 224, 224, 3)).astype(np.float32)),
            "label": torch.from_numpy(rng.integers(0, 21, 8)),
            "weight": torch.ones(8)}
    batch = {k: v.to("cuda") for k, v in host.items()}
    launches.reset()
    loss, _ = engine.train_step(states["cuda"], batch, 21)
    torch.cuda.synchronize()
    counts = launches.read()
    if counts != want:
        raise AssertionError(f"{tag}: launches {counts}, expected {want}")
    t0 = time.perf_counter()
    cpu_loss, _ = engine.train_step(states["cpu"], host, 21)
    cpu_s = time.perf_counter() - t0
    engine.train_step(states["fp64"], {"image": host["image"].double(), "label": host["label"],
                                       "weight": host["weight"].double()}, 21)
    loss_err = abs(float(loss) - float(cpu_loss))
    if loss_err > 1e-4:
        raise AssertionError(f"{tag}: loss {float(loss)} vs the CPU's {float(cpu_loss)}")

    def grads(dev):
        return {n: p.grad.cpu() for n, p in states[dev].model.named_parameters()}

    card, cpu, exact = grads("cuda"), grads("cpu"), grads("fp64")
    head_err = 0.0
    for name in card:
        if name.startswith(HEAD_PARAMS):
            err = float((card[name] - cpu[name]).abs().max()) / max(
                float(cpu[name].abs().max()), 1e-30)
            if err > 1e-4:
                raise AssertionError(f"{tag}: grad of {name} off the CPU's by {err:.3e} of "
                                     f"its max")
            head_err = max(head_err, err)
    card_err, cpu_err = _grad_errors(card, exact), _grad_errors(cpu, exact)
    summary = {}
    for stat, fn in (("max", max), ("median", lambda v: float(np.median(list(v))))):
        summary[stat] = (fn(card_err.values()), fn(cpu_err.values()))
        if summary[stat][0] > 2 * summary[stat][1]:
            raise AssertionError(f"{tag}: {stat} gradient error against the fp64 step "
                                 f"{summary[stat][0]:.3e}, above twice the CPU fp32 step's "
                                 f"{summary[stat][1]:.3e}")
    worst = max(card_err, key=card_err.get)
    cpu_sd = states["cpu"].model.state_dict()
    stat_err = 0.0
    for name, v in states["cuda"].model.state_dict().items():
        if name.endswith(("running_mean", "running_var")):
            if not torch.allclose(v.cpu(), cpu_sd[name], rtol=1e-5, atol=1e-5):
                raise AssertionError(f"{tag}: {name} differs from the CPU's beyond 1e-5")
            stat_err = max(stat_err, float((v.cpu() - cpu_sd[name]).abs().max()))
    print(f"{tag}: one train step, card against CPU (CPU fp32 step {cpu_s:.2f} s): loss "
          f"{float(loss):.6f}, |dloss| {loss_err:.3e} (<= 1e-4); head grads within "
          f"{head_err:.3e} of each tensor's max (<= 1e-4); BatchNorm running stats within "
          f"{stat_err:.3e} (<= 1e-5); every grad against the CPU fp64 step, relative to each "
          f"tensor's max: card max {summary['max'][0]:.3e} ({worst}), median "
          f"{summary['median'][0]:.3e}; CPU fp32 max {summary['max'][1]:.3e}, median "
          f"{summary['median'][1]:.3e} (the card's at most 2x); launches {counts}")
    return counts


def train_rate(engine, get_model, nfp_reference, device_profile_fn):
    """ResNet18 + texture_nfp train steps at full width on batches resident
    on the card: img/s, peak memory, the step's split and its device share."""
    for b in (32, 128):
        model = get_model("resnet18", "texture_nfp", 21).to(
            device="cuda", memory_format=torch.channels_last)
        state = engine.create_train_state(model, 13, 1e-4)
        gen = torch.Generator(device="cuda").manual_seed(14)
        batch = {"image": torch.randn((b, 224, 224, 3), generator=gen, device="cuda"),
                 "label": torch.randint(0, 21, (b,), generator=gen, device="cuda"),
                 "weight": torch.ones(b, device="cuda")}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step_ms = _events_ms(lambda: engine.train_step(state, batch, 21))
        peak = torch.cuda.max_memory_allocated() / 2**30
        params = [p for _, p in state.params]

        def forward():
            model.train()
            return engine.cross_entropy_loss(model(batch["image"]), batch["label"],
                                             batch["weight"])

        fwd_ms = _events_ms(forward)
        fwd_bwd_ms = _events_ms(lambda: torch.autograd.grad(forward(), params))
        opt_ms = _events_ms(state.optimizer.step)
        with torch.no_grad():
            model.eval()
            fmap = model.backbone(batch["image"])
        xg = fmap.detach().requires_grad_(True)
        g = torch.randn((b, 8), generator=gen, device="cuda")

        def nfp_backward():
            return torch.autograd.grad(nfp_reference(xg, 1, "cosine", padding=1, fuse_gap=True),
                                       xg, g)

        nfp_bwd_ms = _events_ms(nfp_backward)
        print(f"train rate: ResNet18 + texture_nfp, 21 classes, 224 px, B={b}, fp32 (TF32 off): "
              f"{step_ms:.3f} ms/step = {b / step_ms * 1e3:.1f} img/s (median of 20 after 3, "
              f"CUDA events); peak memory {peak:.2f} GiB; forward + loss {fwd_ms:.3f} ms, "
              f"backward {fwd_bwd_ms - fwd_ms:.3f} ms (forward + backward {fwd_bwd_ms:.3f}), "
              f"Adam {opt_ms:.3f} ms; the NFP backward alone (plain recompute + autograd on "
              f"({b},7,7,512)) {nfp_bwd_ms:.3f} ms = {nfp_bwd_ms / step_ms:.1%} of the step")
        busy, n_kernels, by_name = device_profile_fn(lambda: engine.train_step(state, batch, 21))
        if not n_kernels:
            print(f"train rate B={b}: torch.profiler recorded no device events: device time "
                  f"not measured")
            continue
        print(f"train rate B={b}: torch.profiler: {n_kernels:.0f} kernels per step, "
              f"{busy:.3f} ms of device time per step ({1 - busy / step_ms:.1%} of the "
              f"{step_ms:.3f} ms step idle); most time: " + top3(by_name))
        del model, state, batch, fmap, xg
        torch.cuda.empty_cache()


def train_cli(launches, cli, Predictor):
    """The training entry point: ``cli.main`` on synthetic data at 224 px,
    B=32, one epoch, in a temporary directory; then a ``Predictor`` on the
    run's ``best`` answers one request. Returns the launches of both."""
    argv = ["--dataset", "synthetic", "--model_type", "resnet18", "--model_variant",
            "texture_nfp", "--input_size", "224", "--batch_size", "32", "--max_epochs", "1",
            "--seeds", "7", "--num_samples", "160", "--learning_rate", "1e-3"]
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as d:
        os.chdir(d)
        out = io.StringIO()
        try:
            launches.reset()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                cli.main(argv)
            cli_s = time.perf_counter() - t0
            best = os.path.join(d, "checkpoints", "synthetic", "exp_seed7", "best")
            for name in ("best", "last"):
                path = os.path.join(os.path.dirname(best), name + ".pt")
                if not os.path.exists(path):
                    raise AssertionError(f"train cli: {path} was not written")
            pred = Predictor("resnet18", "texture_nfp", 4, checkpoint=best, batch_size=32,
                             input_size=224, resize_size=224, device="cuda")
            request = [np.random.default_rng(15).random((240, 260, 3), dtype=np.float32)
                       for _ in range(3)]
            res = pred.predict(request)
            counts = launches.read()
        finally:
            os.chdir(cwd)
    text = out.getvalue()
    final = [line for line in text.splitlines() if "Final Test Accuracy" in line]
    if not final:
        raise AssertionError("train cli: no 'Final Test Accuracy' line:\n" + text[-2000:])
    probs = res["probabilities"]
    if probs.shape != (3, 4) or not np.isfinite(probs).all():
        raise AssertionError(f"train cli: the Predictor gave {probs.shape}, finite "
                             f"{np.isfinite(probs).all()}")
    # 112 train images: 3 steps of 32; one val, one test and one served batch
    if counts != dict(nfp_small=6, nfp_large=0, nfp_strip=0, int8_gemm=0, int8_conv=0):
        raise AssertionError(f"train cli: launches {counts}; expected K1 six times (3 train "
                             f"steps, one val, one test and one served batch) and no other")
    print(f"train cli: cli.main(synthetic, resnet18, texture_nfp, 224 px, B=32, 1 epoch, 160 "
          f"samples) in {cli_s:.2f} s: {final[0].strip()}; best and last written; a "
          f"Predictor on best answered 3 images, labels {res['label'].tolist()}; launches "
          f"{counts}")
    return counts


def load_parent(path):
    """``ops.nfp_cuda`` of another checkout of this repository (for example
    the parent commit, unpacked with ``git archive``), imported under the
    package name ``parent_port`` so both versions load side by side; its K1,
    K2 and K3 build into that checkout's ``csrc/_build``, and ptxas' register
    and spill lines for them are printed."""
    import importlib
    import importlib.util
    pkg = os.path.join(os.path.abspath(path), "neighbour_feature_pooling_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        "parent_port", os.path.join(pkg, "__init__.py"), submodule_search_locations=[pkg])
    module = importlib.util.module_from_spec(spec)
    sys.modules["parent_port"] = module
    spec.loader.exec_module(module)
    cuda = importlib.import_module("parent_port.ops.nfp_cuda")
    for kernel, log in cuda._build.build_all(["nfp_small", "nfp_large", "nfp_strip"]).items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  parent {kernel}: {line.strip()}")
    return cuda


def main():
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", metavar="DIR",
                    help="another checkout of the repository: time its K1, K2 and K3 "
                         "beside this one's")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py needs a CUDA device and none is available")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from neighbour_feature_pooling_tpu_torch.ops import _build
    from neighbour_feature_pooling_tpu_torch.ops.neighborhood import (
        nfp_output_size, nfp_reference, num_neighbors)
    from neighbour_feature_pooling_tpu_torch.models.heads import gap2d
    from neighbour_feature_pooling_tpu_torch.ops.int8_conv import (
        int8_conv2d, int8_conv2d_reference, pack_conv_weight)
    from neighbour_feature_pooling_tpu_torch.ops.int8_gemm import (
        int8_gemm, int8_gemm_reference, pack_weight)
    from neighbour_feature_pooling_tpu_torch.ops.nfp_cuda import (
        _k1_plan, _k2_plan, nfp, nfp_kernel, nfp_large_cuda, nfp_small_cuda, nfp_strip_cuda)
    from neighbour_feature_pooling_tpu_torch.tools import bench_nfp_kernel
    from neighbour_feature_pooling_tpu_torch.serve import Predictor
    from neighbour_feature_pooling_tpu_torch import cli
    from neighbour_feature_pooling_tpu_torch.models import get_model
    from neighbour_feature_pooling_tpu_torch.train import engine

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

    parent = None if args.parent is None else load_parent(args.parent)

    def planned(plan_fn, fmt):
        def note(shape, dtype, measure, radius, kw):
            b, h, w, c = shape
            pad, dil = kw.get("padding", 0), kw.get("dilation", 1)
            return fmt(plan_fn(b, h, w, c, nfp_output_size(h, radius, 1, pad, dil),
                               nfp_output_size(w, radius, 1, pad, dil), radius, dil, dtype,
                               measure=measure))
        return note

    k1_plan = planned(lambda *a, measure: _k1_plan(*a),  # one plan for every measure
                      lambda p: f"rows={p.rows} G={p.group} chunk={p.chunk}")
    # K2 and K3 share the template and the plan
    k2_plan = planned(_k2_plan, lambda p: f"rows={p.rows} step={p.step} cols={p.cols} "
                                          f"G={p.group} chunk={p.chunk} stride={p.stride}")

    print("kernels: nfp_small (K1) against nfp_reference on the card "
          "(fp32 rtol=atol=1e-5; bf16 within one bf16 ulp)")
    rows = dict(nfp_small=check_kernel(nfp_small_cuda, k1_cases(), "serve B=32 float32 fuse_gap=True",
                                       nfp_reference, num_neighbors, nfp_output_size,
                                       note=k1_plan,
                                       parent=parent and parent.nfp_small_cuda))
    print("kernels: nfp_large (K2) against nfp_reference on the card "
          "(fp32 rtol=atol=1e-5; bf16 within one bf16 ulp)")
    rows["nfp_large"] = check_kernel(nfp_large_cuda, k2_cases(), K2_MAIN,
                                     nfp_reference, num_neighbors, nfp_output_size,
                                     note=k2_plan, parent=parent and parent.nfp_large_cuda)
    print("kernels: nfp_strip (K3) against nfp_reference on the card "
          "(fp32 rtol=atol=1e-5; bf16 within one bf16 ulp)")
    rows["nfp_strip"] = check_kernel(nfp_strip_cuda, k3_cases(), K3_MAIN,
                                     nfp_reference, num_neighbors, nfp_output_size,
                                     note=k2_plan, parent=parent and parent.nfp_strip_cuda)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"serve: torch.backends.cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"torch.backends.cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    rows.update(check_int8_kernels(int8_gemm, int8_gemm_reference, pack_weight,
                                   int8_conv2d, int8_conv2d_reference, pack_conv_weight))
    launches = Launches(nfp_small=nfp_small_cuda, nfp_large=nfp_large_cuda,
                        nfp_strip=nfp_strip_cuda, int8_gemm=int8_gemm, int8_conv=int8_conv2d)
    per_path = [serve_resnet18(Predictor, launches),
                serve_mobilenetv3(Predictor, launches, gap2d, nfp)]
    other_mobilenetv3_variants(Predictor, launches)
    per_path.append(serve_resnet18_int8(Predictor, launches))
    per_path.append(kernel_entry(launches, bench_nfp_kernel, nfp_kernel, nfp_reference))
    none = dict(nfp_small=0, nfp_large=0, nfp_strip=0, int8_gemm=0, int8_conv=0)
    per_path.append(train_parity(launches, engine, get_model, "resnet18", "texture_nfp",
                                 dict(none, nfp_small=1)))
    per_path.append(train_parity(launches, engine, get_model, "mobilenetv3", "multi_stage_nfp",
                                 dict(none, nfp_small=2, nfp_large=3)))
    train_rate(engine, get_model, nfp_reference, device_profile)
    per_path.append(train_cli(launches, cli, Predictor))
    counts = {k: sum(p[k] for p in per_path) for k in rows}

    sources = dict(nfp_small=("neighbour_feature_pooling_tpu_torch/csrc/nfp_small.cu",
                              "neighbour_feature_pooling_tpu/ops/nfp_pallas.py:69"),
                   nfp_large=("neighbour_feature_pooling_tpu_torch/csrc/nfp_large.cu",
                              "neighbour_feature_pooling_tpu/ops/nfp_pallas.py:156"),
                   nfp_strip=("neighbour_feature_pooling_tpu_torch/csrc/nfp_strip.cu",
                              "neighbour_feature_pooling_tpu/ops/nfp_pallas.py:105"),
                   int8_gemm=("neighbour_feature_pooling_tpu_torch/csrc/int8_gemm.cu",
                              "neighbour_feature_pooling_tpu/ops/int8_gemm.py:39"),
                   int8_conv=("neighbour_feature_pooling_tpu_torch/csrc/int8_conv.cu",
                              "neighbour_feature_pooling_tpu/ops/int8_conv.py:91"))
    print(json.dumps({"kernels": [dict(
        name=k, route="cuda", source=sources[k][0], replaces=sources[k][1],
        launches=counts[k], **{"library_ms": None, **rows[k]}) for k in rows]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
