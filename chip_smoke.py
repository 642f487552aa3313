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
   CPU, with each one's launch counts; then ResNet50 + texture_nfp and
   ViT-Tiny + texture_nfp served as ResNet18 is (K1 on the (B,7,7,2048) and
   (B,14,14,192) head maps, once per batch), and ResNet18 + nfp_at_layer at
   taps 3, 2 and 0 (one batch each against the CPU; K1 1, 1 and 0 times:
   the tap-0 map runs the plain version); then the texture heads: one
   batch of 8 at 224 px of each of the fractal, lacunarity, DeepTEN and
   RADAM heads on every backbone, of the legacy grid (``gap_mlp`` …
   ``adaptive_fusion_nfp``) on ResNet18, MobileNetV3 and ViT-Tiny and of
   ResNet18's ``se_gate`` (seeded weights, BatchNorm statistics
   recalibrated on the batch), each against the CPU ``Predictor`` (labels
   equal, max |dprob| <= 1e-4) with K1 launched 0 times for the four
   active heads and ``gap_mlp``, twice for ``multi_radius_nfp`` (R=1 and
   R=2) and once for every other legacy head, and K2-K5 never; and
   ResNet18's forward time at B=32 and 128 with each active head beside
   texture_nfp;
7. int8 kernels: K4 (``int8_gemm``) and K5 (``int8_conv``) against their
   plain versions on the card, bit for bit (``torch.equal``), at every
   ResNet18 shape of int8 serving at B=32 and some at B=128, at ResNet50's,
   ViT-Tiny's (M = B·200 and a ragged B·197) and MobileNetV3's (a 4-byte A
   path, M = B) B=32 GEMMs, ResNet50's strided 3x3s and ViT's 16x16/16
   patch embed, on ragged shapes that reach both tile sizes and the
   16-byte, 4-byte and byte paths of A, in the s32, fused fp32 and s8 +
   ReLU forms, with the weight packed once (as the model does; what the
   times are of) and packed in the call; times beside the bound (bytes at
   3.35 TB/s or int8 operations at 1,979 TOPS), K4 beside
   ``torch._int_mm`` (cuBLASLt s8, a yardstick the port never calls), K5
   beside a cuDNN fp32 conv with TF32 off (context only);
8. serve int8: an int8 ``Predictor`` (``serve_int8``) of ResNet18 +
   texture_nfp (17 K5, 3 K4, 1 K1 launches per batch), then of ResNet50
   and ViT-Tiny + texture_nfp and MobileNetV3 + gap_only and
   multi_stage_nfp (``INT8_PATHS``: 17 / 1 / 0 / 0 K5, 36 / 48 / 36 / 37
   K4), answers the three requests, dynamic and then ``calibrate()``d on
   64 images, with one s8-emitting K4 or K5 launch per chain and batch (8
   on ResNet18, 32 on ResNet50, none on the others); each run against a
   CPU int8 ``Predictor`` (TF32 off; the calibrated one given the card's
   scales and chains) layer by layer, every int8 layer bit for bit on the
   card's input to it and the probabilities within 1e-4, and free-running
   (held to 1e-4 where only exact ops feed the int8 layers:
   ``int8_free_running``); forward times at B=32 and B=128 beside fp32,
   the host's time to enqueue a forward, and a torch.profiler split into
   K4, K5 and the rest; then the int8 heads: one batch of 8 of every other
   registry pair, K4 and K5 launched once per int8 layer call, against
   the CPU the same way;
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
   fp32 step's own error, floored at fp32 rounding, 1e-6 (``train_parity``
   says why), and K1 launched once
   by the step (the NFP backward launches nothing: it differentiates the
   plain version); the same for MobileNetV3-Large + multi_stage_nfp (K2
   three times, K1 twice), ResNet50 + texture_nfp and ViT-Tiny +
   texture_nfp (K1 once each), ResNet18 + texture_deepten and
   texture_radam (no launch; DeepTEN's ``bn`` statistics, which fp32
   cannot compute to 1e-5, within twice the CPU's error against fp64) and
   MobileNetV3 + multi_radius_nfp (K1 twice a step), whose step is
   chaotic at fp32 rounding: it runs on the batch and five copies
   perturbed by 1e-7, and the card's smallest and greatest error over the
   six are held to twice the CPU's; (b) for ResNet18, ResNet50 and ViT-Tiny +
   texture_nfp, the train-step rate at B=32 and B=128 on batches
   resident on the card (median of 20 steps after 3, CUDA events), the
   peak memory, the step split into forward, backward and optimizer, the
   NFP backward alone, and a torch.profiler device-busy share and kernels
   per step; then ResNet18's train step at B=32 with the fractal,
   lacunarity, DeepTEN, RADAM and gap_mlp heads beside texture_nfp's
   (dropout masks drawn on the card); (c) the CLI, ``cli.main`` on synthetic data at 224 px, B=32,
   one epoch, in a temporary directory, then a ``Predictor`` serving one
   request from the run's ``best`` checkpoint.

Each phase prints its wall seconds. Any failure raises and the exit code is
non-zero. The last two lines are a
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

#: the fp32 operations a measure needs per channel, as (per (position,
#: neighbour) pair, per input pixel once): what the function needs, not
#: what a kernel's loop body does. A dot product is one FMA (2) a channel;
#: cosine, scs and gfc add each pixel's squared norm once (2); pearson
#: centres each pixel once (mean, subtract, squared norm: 4) and then takes
#: a dot; a per-pixel |x| + eps, sqrt or log is computed once per pixel,
#: so the pair pays only the subtract, the product and the sum after it
FLOPS_PER_TERM = {"cosine": (2, 2), "scs": (2, 2), "gfc": (2, 2), "dot": (2, 0),
                  "attention": (2, 0), "norm": (3, 0), "pearson": (2, 4), "smith": (2, 2),
                  "jeffrey": (4, 3), "canberra": (5, 2), "rmse": (3, 0), "geman": (5, 0),
                  "emd": (3, 0), "hellinger": (3, 3), "squaredchord": (3, 3),
                  "chisquared1": (5, 2), "chisquared2": (4, 2)}


def nfp_flops(measure, pixels, pairs, channels):
    """fp32 operations of one NFP over ``pixels`` input pixels and
    ``pairs`` (position, neighbour) pairs of ``channels`` channels."""
    per_pair, per_pixel = FLOPS_PER_TERM[measure]
    return channels * (pairs * per_pair + pixels * per_pixel)


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
    for b in (32, 128):  # the heads of the ResNet50 and ViT-Tiny paths
        cases += [(f"resnet50 head B={b}", (b, 7, 7, 2048), torch.float32, "cosine",
                   dict(padding=1, fuse_gap=True)),
                  (f"vittiny head B={b}", (b, 14, 14, 192), torch.float32, "cosine",
                   dict(padding=1, fuse_gap=True))]
    cases += [  # ResNet18 nfp_at_layer: the zoo's padding 0, the map form
        ("nfp_at_layer idx 3 / legacy map, padding 0", (32, 7, 7, 512), torch.float32,
         "cosine", dict(padding=0)),
        ("nfp_at_layer idx 2 map, padding 0", (32, 14, 14, 256), torch.float32, "cosine",
         dict(padding=0)),
    ]
    cases += [  # the legacy grid's maps: multi_radius_nfp's R=2, padding 2, and
        # the R=1 map form on MobileNetV3's and ViT-Tiny's head maps
        ("legacy R=2 padding 2 map, resnet18", (32, 7, 7, 512), torch.float32, "cosine",
         dict(radius=2, padding=2)),
        ("legacy R=2 padding 2 map, mnv3", (32, 7, 7, 960), torch.float32, "cosine",
         dict(radius=2, padding=2)),
        ("legacy map, mnv3", (32, 7, 7, 960), torch.float32, "cosine", dict(padding=1)),
        ("legacy map, vittiny", (32, 14, 14, 192), torch.float32, "cosine", dict(padding=1)),
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
        n_flops = nfp_flops(measure, b * h * w, b * positions * num_neighbors(radius), c)
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
        cpu = Predictor(**dict(kw, checkpoint=path), device="cpu")
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


#: the heads whose int8 linears read fp32 means and matmuls
INT8_HEADS_AFTER_FP32 = ("gap_mlp", "nfp_conv_mlp", "gap_nfp_conv_mlp_concat",
                         "gap_nfp_noconv_mlp_concat", "nfp_head", "multi_radius_nfp",
                         "adaptive_fusion_nfp", "se_gate")


def int8_free_running(model_type, variant):
    """Whether an int8 model's free-running answers on the card can match
    the CPU's within 1e-4: only where every op that feeds an int8 layer is
    exact on both (ResNet's folded convs, adds, ReLU and max-pool; the
    fractal head's conv reads the backbone's map). An fp32 op that rounds
    differently on the card in the last bit (LayerNorm and attention,
    depthwise convs and SE, a mean before a head's linear) moves values
    across rounding steps of the next quantization, and those steps
    compound through the network."""
    return model_type in ("resnet18", "resnet50") and variant not in INT8_HEADS_AFTER_FP32


def match_cpu_int8(Predictor, pred, kw, batches, tag, setup=None, exact=True):
    """An int8 Predictor against a CPU one with the same weights (and
    ``setup(cpu)``): layer by layer on the first batch, each int8 layer of
    the CPU model given the card's input to it must give the card's output
    bit for bit, and the CPU forward then goes on from the card's output,
    to probabilities within 1e-4 of the card's with the labels equal; then
    free-running, on every batch held to the same where ``exact``
    (``int8_free_running``), else on the first batch and printed."""
    from neighbour_feature_pooling_tpu_torch.quant import Int8Conv2d, Int8Linear
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "weights.pt")
        torch.save(pred.state_dict(), path)
        cpu = Predictor(**dict(kw, checkpoint=path), device="cpu")
    if setup is not None:
        setup(cpu)

    def int8_layers(model):
        return [(n, m) for n, m in model.named_modules() if isinstance(m, (Int8Conv2d, Int8Linear))]

    x = torch.from_numpy(np.ascontiguousarray(batches[0][0][:pred.batch_size]))
    seen, differ = {}, []
    hooks = [m.register_forward_hook(lambda mod, args, out, n=n: seen.__setitem__(
        n, (args[0].cpu(), out.cpu()))) for n, m in int8_layers(pred.model)]
    with torch.inference_mode():
        card = torch.softmax(pred.model(x.to("cuda")), dim=-1).cpu()
    for h in hooks:
        h.remove()

    def compare(mod, args, out, n):
        if not torch.equal(out, seen[n][1]):
            differ.append(n)
        return seen[n][1]

    hooks = [h for n, m in int8_layers(cpu.model) for h in (
        m.register_forward_pre_hook(lambda mod, args, n=n: (seen[n][0],)),
        m.register_forward_hook(lambda mod, args, out, n=n: compare(mod, args, out, n)))]
    with torch.inference_mode():
        forced = torch.softmax(cpu.model(x), dim=-1)
    for h in hooks:
        h.remove()
    if differ or len(seen) != len(int8_layers(cpu.model)):
        raise AssertionError(f"{tag}: {len(differ)} of {len(seen)} int8 layers differ from the "
                             f"CPU's on the same input: {differ[:4]}")
    worst = float((card - forced).abs().max())
    if not torch.equal(card.argmax(-1), forced.argmax(-1)) or worst > 1e-4:
        raise AssertionError(f"{tag}: layer by layer, max |dprob| {worst:.3e} vs the CPU")
    free, same = 0.0, True
    for images, out in batches if exact else batches[:1]:
        want = cpu.predict(images, preprocessed=True)
        same &= bool((out["label"] == want["label"]).all())
        free = max(free, float(np.abs(out["probabilities"] - want["probabilities"]).max()))
    if exact and (not same or free > 1e-4):
        raise AssertionError(f"{tag}: free-running max |dprob| {free:.3e} vs the CPU "
                             f"(labels equal: {same})")
    print(f"{tag}: matches the CPU Predictor: {len(seen)} int8 layers equal bit for bit on the "
          f"card's inputs, then max |dprob| {worst:.3e} (<= 1e-4), labels equal; free-running "
          f"max |dprob| {free:.3e}, labels equal {same}"
          + (" (<= 1e-4)" if exact else " (not held: an fp32 op feeds an int8 layer)"))


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
        for k in ("int8_gemm", "int8_conv"):
            self.wrappers[k].s8_launches = 0

    def read(self):
        return {k: w.launches for k, w in self.wrappers.items()}

    def s8(self):
        """The K4 and K5 launches that emitted int8 (chained producers)."""
        return sum(self.wrappers[k].s8_launches for k in ("int8_gemm", "int8_conv"))


def head_map(model, x):
    """The NHWC map a texture model's head reads: the backbone's output,
    ViT's tokens through ``tokens_to_map``."""
    from neighbour_feature_pooling_tpu_torch.models.backbones.vit import tokens_to_map
    fmap = model.backbone(x)
    return tokens_to_map(fmap) if model.model_type == "vittiny" else fmap


def serve_texture_nfp(Predictor, launches, model_type="resnet18", seed=0):
    """A backbone + texture_nfp ``Predictor`` (the first slice's main path
    on ResNet18; ResNet50 and ViT-Tiny in the twelfth): three requests, K1
    once per batch, the CPU's answers, then the forward rate split into
    the backbone and the NFP head + fc. Returns its launches of each
    kernel."""
    tag = f"serve {model_type}"
    kw = dict(model_type=model_type, model_variant="texture_nfp", num_classes=21,
              batch_size=32, input_size=224)
    t0 = time.perf_counter()
    pred = Predictor(**kw, device="cuda")
    print(f"{tag}: Predictor({model_type}, texture_nfp, 21 classes, batch_size=32, "
          f"224 px) on cuda in {time.perf_counter() - t0:.2f} s")
    requests = requests_of(np.random.default_rng(seed))
    pred.predict(requests[0])  # warm-up: cuDNN plans, first launches

    launches.reset()
    outs, lat = answer(pred, requests, tag)
    counts = launches.read()

    expected = sum(-(-len(r) // 32) for r in requests)
    if counts != dict(nfp_small=expected, nfp_large=0, nfp_strip=0, int8_gemm=0, int8_conv=0):
        raise AssertionError(f"{tag}: launches {counts}, expected "
                             f"nfp_small {expected} (= batches) and no other")
    pre = []
    for req in requests:
        t0 = time.perf_counter()
        pred.preprocess(req)
        pre.append(time.perf_counter() - t0)
    print(f"{tag}: requests of {[len(r) for r in requests]} images answered in "
          f"{[round(t * 1e3, 2) for t in lat]} ms, of which host preprocessing "
          f"{[round(t * 1e3, 2) for t in pre]} ms; launches {counts}")
    batch = pred.preprocess(requests[1])
    t0 = time.perf_counter()
    torch.from_numpy(batch).to("cuda")
    torch.cuda.synchronize()
    copy_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pred.predict(batch, preprocessed=True)
    print(f"{tag}: one preprocessed batch of 32: predict "
          f"{(time.perf_counter() - t0) * 1e3:.2f} ms, while a host-to-device copy of its "
          f"{batch.nbytes / 1e6:.1f} MB alone takes {copy_s * 1e3:.2f} ms")
    match_cpu(Predictor, pred, kw, [(pred.preprocess(r), o) for r, o in zip(requests, outs)],
              tag)

    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    model = pred.model
    for b in (32, 128):
        x = torch.randn((b, 224, 224, 3), generator=gen, device="cuda")
        with torch.inference_mode():
            fmap = head_map(model, x)
            ms = median_ms(lambda: model(x), runs=20)
            backbone_ms = median_ms(lambda: head_map(model, x), runs=20)
            head_ms = median_ms(lambda: model.fc(model.pool(fmap)), runs=20)
            busy, n_kernels, by_name = device_profile(lambda: model(x))
        print(f"{tag}: forward B={b} fp32 {ms:.3f} ms/batch = {b / ms * 1e3:.1f} img/s; "
              f"backbone {backbone_ms:.3f} ms, NFP head + fc {head_ms:.3f} ms "
              f"(median of 20, CUDA events)")
        if not n_kernels:
            print(f"{tag}: forward B={b} torch.profiler recorded no device events: "
                  f"device time not measured")
            continue
        k1 = sum(t for n, t in by_name.items() if "nfp_small" in n)
        print(f"{tag}: forward B={b} torch.profiler: {n_kernels:.0f} kernels, "
              f"{busy:.3f} ms of device time per forward ({1 - busy / ms:.1%} of the "
              f"{ms:.3f} ms forward idle), K1 {k1:.3f} ms; most time: " + top3(by_name))
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


#: ResNet18 nfp_at_layer: K1 launches per batch by nfp_layer_idx (224 px,
#: padding 0: 5x5 and 12x12 maps on K1; layer1's 54x54 map at C=64 is past
#: K2's cap and runs the plain version)
NFP_AT_LAYER_LAUNCHES = {3: 1, 2: 1, 0: 0}


def nfp_at_layer(Predictor, launches):
    """One batch of 8 of ResNet18 + nfp_at_layer at each tap on the card
    against the CPU, with its launch counts; returns them."""
    x = np.random.default_rng(16).standard_normal((8, 224, 224, 3)).astype(np.float32)
    total = None
    for idx, want in NFP_AT_LAYER_LAUNCHES.items():
        kw = dict(model_type="resnet18", model_variant="nfp_at_layer", num_classes=21,
                  batch_size=8, input_size=224, model_kwargs=dict(nfp_layer_idx=idx))
        pred = Predictor(**kw, device="cuda")
        launches.reset()
        out = pred.predict(x, preprocessed=True)
        counts = launches.read()
        if counts != dict(nfp_small=want, nfp_large=0, nfp_strip=0, int8_gemm=0, int8_conv=0):
            raise AssertionError(f"nfp_at_layer idx {idx}: launches {counts}, expected K1 {want} "
                                 f"and no other")
        print(f"nfp_at_layer idx {idx}: launches {counts}")
        match_cpu(Predictor, pred, kw, [(x, out)], f"nfp_at_layer idx {idx}")
        total = counts if total is None else {k: total[k] + counts[k] for k in total}
    return total


#: the pairs of the texture heads phase: the four active heads on every
#: backbone, the legacy grid on ResNet18, MobileNetV3 and ViT-Tiny, and
#: ResNet18's se_gate
ACTIVE_HEADS = ("texture_fractal", "texture_lacunarity", "texture_deepten", "texture_radam")
LEGACY_GRID = ("gap_mlp", "nfp_conv_only", "nfp_conv_mlp", "gap_nfp_conv_nomlp_concat",
               "gap_nfp_noconv_nomlp_concat", "gap_nfp_conv_mlp_concat",
               "gap_nfp_noconv_mlp_concat", "nfp_head", "multi_radius_nfp",
               "similarity_aware_pooling", "adaptive_fusion_nfp")
HEAD_PAIRS = ([(mt, v) for mt in ("resnet18", "resnet50", "mobilenetv3", "vittiny")
               for v in ACTIVE_HEADS]
              + [(mt, v) for mt in ("resnet18", "mobilenetv3", "vittiny") for v in LEGACY_GRID]
              + [("resnet18", "se_gate")])


def head_k1_launches(variant):
    """K1 launches per batch of a texture-heads pair: none for the heads
    without NFP, two for multi_radius_nfp (R=1 and R=2), one otherwise."""
    if variant in ACTIVE_HEADS or variant == "gap_mlp":
        return 0
    return 2 if variant == "multi_radius_nfp" else 1


def recalibrate_batchnorm(model, x):
    """Set every BatchNorm's running statistics to those of one train-mode
    forward of ``x`` (dropout drawn from a seeded generator), as training
    leaves them. With seeded weights and identity statistics MobileNetV3's
    960-channel map has a std of ~2e-4 at 224 px, and the fractal and
    lacunarity heads on it give logits within 1e-7 of each other, whose
    argmax is rounding; recalibrated, every layer's output is of unit
    scale and the labels mean something."""
    norms = [m for m in model.modules() if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)]
    for m in norms:
        m.momentum = 1.0
    model.train()
    with torch.no_grad():
        model(x, generator=torch.Generator(device=x.device).manual_seed(0))
    for m in norms:
        m.momentum = 0.1
    model.eval()


def texture_heads(Predictor, launches, get_model, init_params):
    """One batch of 8 at 224 px through a ``Predictor`` on the card for
    every pair of ``HEAD_PAIRS`` (seeded weights, BatchNorm statistics
    recalibrated on the batch), against the CPU ``Predictor`` with the
    same weights, with its launch counts; then ResNet18's forward time at
    B=32 and 128 with each active head beside texture_nfp. Returns the
    launches."""
    x = np.random.default_rng(30).standard_normal((8, 224, 224, 3)).astype(np.float32)
    total = dict(nfp_small=0, nfp_large=0, nfp_strip=0, int8_gemm=0, int8_conv=0)
    for model_type, variant in HEAD_PAIRS:
        kw = dict(model_type=model_type, model_variant=variant, num_classes=21, batch_size=8,
                  input_size=224)
        pred = Predictor(**kw, device="cuda")
        recalibrate_batchnorm(pred.model, torch.from_numpy(x).to("cuda"))
        launches.reset()
        out = pred.predict(x, preprocessed=True)
        counts = launches.read()
        want = dict(total, nfp_small=head_k1_launches(variant))
        tag = f"texture heads {model_type}/{variant}"
        if counts != want:
            raise AssertionError(f"{tag}: launches {counts}, expected {want}")
        if not np.isfinite(out["probabilities"]).all():
            raise AssertionError(f"{tag}: non-finite probabilities")
        top2 = np.sort(out["probabilities"], axis=-1)[:, -2:]
        print(f"{tag}: launches {counts}; least top-1 over top-2 probability margin "
              f"{float((top2[:, 1] - top2[:, 0]).min()):.3e}")
        match_cpu(Predictor, pred, kw, [(x, out)], tag)
        total = {k: total[k] + counts[k] for k in total}
        del pred

    gen = torch.Generator(device="cuda").manual_seed(31)
    for b in (32, 128):
        xb = torch.randn((b, 224, 224, 3), generator=gen, device="cuda")
        times = {}
        for variant in ("texture_nfp",) + ACTIVE_HEADS:
            model = init_params(get_model("resnet18", variant, 21),
                                torch.Generator().manual_seed(0))
            model = model.to(device="cuda", memory_format=torch.channels_last).eval()
            with torch.inference_mode():
                times[variant] = median_ms(lambda: model(xb), runs=20)
            del model
        print(f"texture heads: resnet18 forward B={b} fp32, ms/batch (median of 20, CUDA "
              f"events): " + ", ".join(f"{v} {t:.3f} ({b / t * 1e3:.1f} img/s)"
                                       for v, t in times.items()))
    return total


#: K4 cases: (label, M, K, N, forms); the ResNet18 downsample GEMMs at 224 px
K4_MAIN = "layer2 downsample B=32 fp32"
K4_SHAPES = [("layer2 downsample B=32", 25088, 64, 128), ("layer3 downsample B=32", 6272, 128, 256),
             ("layer4 downsample B=32", 1568, 256, 512), ("layer2 downsample B=128", 100352, 64, 128),
             ("layer3 downsample B=128", 25088, 128, 256), ("layer4 downsample B=128", 6272, 256, 512),
             ("ragged M, K, N", 1000, 100, 70), ("ragged, tiny", 37, 300, 9),
             ("ragged, K 37 (byte path)", 200, 37, 24),
             # the int8 paths of ResNet50, ViT-Tiny and MobileNetV3 at B=32
             ("resnet50 layer1 conv3 B=32", 100352, 64, 256),
             ("resnet50 layer1 conv1 B=32", 100352, 256, 64),
             ("resnet50 layer3 conv3 B=32", 6272, 256, 1024),
             ("resnet50 layer3 conv1 B=32", 6272, 1024, 256),
             ("vittiny qkv B=32", 6400, 192, 576), ("vittiny fc2 B=32", 6400, 768, 192),
             ("vittiny qkv, 197 tokens (ragged M) B=32", 6304, 192, 576),
             ("mobilenetv3 conv_pw Cin 72 (4-byte A) B=32", 100352, 72, 24),
             ("mobilenetv3 SE conv_expand (M = B, Cin 168) B=32", 32, 168, 672)]
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
    # ResNet50's layer1 and layer4 3x3 are ResNet18's above; its strided ones
    ("resnet50 layer2.0 3x3/2 B=32", (32, 56, 56, 128), (3, 3, 128), ((1, 1), (1, 1)), (2, 2)),
    ("resnet50 layer4.0 3x3/2 B=32", (32, 14, 14, 512), (3, 3, 512), ((1, 1), (1, 1)), (2, 2)),
    ("vittiny patch embed 16x16/16 B=32", (32, 224, 224, 3), (16, 16, 192), ((0, 0), (0, 0)),
     (16, 16)),
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
            if form == "fp32":
                lib_ms, why = _int_mm_ms(a, b)
                s32_ms = median_ms(lambda: int8_gemm(a, b, b_packed=bp))
                print(f"  {label}: torch._int_mm (cuBLASLt s8 -> s32, no epilogue) "
                      + (f"{lib_ms * 1e3:.2f} us" if lib_ms is not None else f"refused: {why}")
                      + f"; K4 in its s32 form {s32_ms * 1e3:.2f} us")
                if f"{label} {form}" == K4_MAIN:
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


#: the int8 main paths: (model type, variant) → launches per batch (K5,
#: K4, K1, K2; no K3) and the s8 chains ``calibrate()`` keeps, as the JAX
#: package finds them (tests/test_torch_int8_models.py): every
#: conv1 → conv2 of a ResNet18 block; conv1 → conv2 → conv3 of each of
#: ResNet50's 16 bottlenecks (16 on K4, 16 on K5); none on ViT-Tiny, and on
#: MobileNetV3 the end-to-end guard drops every candidate
INT8_PATHS = {
    ("resnet18", "texture_nfp"): (dict(int8_conv=17, int8_gemm=3, nfp_small=1), 8),
    ("resnet50", "texture_nfp"): (dict(int8_conv=17, int8_gemm=36, nfp_small=1), 32),
    ("vittiny", "texture_nfp"): (dict(int8_conv=1, int8_gemm=48, nfp_small=1), 0),
    ("mobilenetv3", "gap_only"): (dict(int8_gemm=36), 0),
    ("mobilenetv3", "multi_stage_nfp"): (dict(int8_gemm=37, nfp_small=2, nfp_large=3), 0),
}


def seeded_weights(get_model, init_params, model_type, variant, path):
    """Save to ``path`` the weights of ``init_params`` seed 0 with the
    BatchNorm statistics recalibrated on one batch of 8 on the card
    (``recalibrate_batchnorm``: with identity statistics MobileNetV3's
    logits agree to 1e-7 and nothing is compared)."""
    model = init_params(get_model(model_type, variant, 21), torch.Generator().manual_seed(0))
    model = model.to(device="cuda", memory_format=torch.channels_last)
    x = torch.from_numpy(np.random.default_rng(34).standard_normal((8, 224, 224, 3))
                         .astype(np.float32)).to("cuda")
    recalibrate_batchnorm(model, x)
    torch.save({k: v.cpu() for k, v in model.state_dict().items()}, path)


def profile_split(tag, model, x, ms):
    """A torch.profiler split of one forward: K4, K5 and the rest."""
    with torch.inference_mode():
        busy, n_kernels, by_name = device_profile(lambda: model(x))
    if not n_kernels:
        print(f"{tag}: forward B={x.shape[0]} torch.profiler recorded no device events: "
              f"device time not measured")
        return
    k4 = sum(t for n, t in by_name.items() if "int8_gemm_kernel" in n)
    k5 = sum(t for n, t in by_name.items() if "int8_conv_kernel" in n)
    print(f"{tag}: forward B={x.shape[0]} torch.profiler: {n_kernels:.0f} kernels, {busy:.3f} ms "
          f"of device time per forward ({1 - busy / ms:.1%} of the {ms:.3f} ms forward idle); "
          f"K5 {k5:.3f} ms, K4 {k4:.3f} ms, the rest {busy - k4 - k5:.3f} ms per forward; "
          f"most time: " + top3(by_name))


def serve_int8(Predictor, launches, model_type, variant, checkpoint=None, seed=6):
    """An int8 ``Predictor`` (21 classes, B=32, 224 px) answers the three
    requests, dynamic and then ``calibrate()``d on 64 images, with the
    launches of ``INT8_PATHS`` per batch and, calibrated, one s8-emitting
    K4 or K5 launch per chain and batch; each run against a CPU int8
    ``Predictor`` with the same weights (the calibrated one given the
    card's scales and chains); then forward ms at B=32 and B=128 beside
    fp32, the host's enqueue time and a profiler split. Returns its
    launches of each kernel."""
    kw = dict(model_type=model_type, model_variant=variant, num_classes=21, batch_size=32,
              input_size=224, quantize="int8", checkpoint=checkpoint)
    name = f"{model_type} {variant}"
    t0 = time.perf_counter()
    pred = Predictor(**kw, device="cuda")
    print(f"serve int8 {name}: Predictor(21 classes, batch_size=32, 224 px, quantize='int8', "
          f"{'seeded weights' if checkpoint is None else 'seeded, BatchNorm recalibrated'}) "
          f"on cuda in {time.perf_counter() - t0:.2f} s")
    per_batch, want_chains = INT8_PATHS[(model_type, variant)]
    rng = np.random.default_rng(seed)
    requests = requests_of(rng)
    batches = sum(-(-len(r) // 32) for r in requests)
    gen = torch.Generator(device="cuda").manual_seed(7)
    xs = {b: torch.randn((b, 224, 224, 3), generator=gen, device="cuda") for b in (32, 128)}
    fp32 = Predictor(**dict(kw, quantize=None), device="cuda").model
    total = {k: 0 for k in launches.wrappers}

    for tier in ("dynamic", "calibrated"):
        tag = f"serve int8 {name} {tier}"
        if tier == "calibrated":
            t0 = time.perf_counter()
            n_layers = pred.calibrate([rng.random((256, 256, 3), dtype=np.float32)
                                       for _ in range(64)])
            chains = len(pred._int8_chains or {})
            print(f"{tag}: calibrate() on 64 images: {n_layers} layers, {chains} chains, "
                  f"in {time.perf_counter() - t0:.2f} s")
            if chains != want_chains:
                raise AssertionError(f"{tag}: {chains} chains, expected {want_chains}")
        pred.predict(requests[0])  # warm-up
        launches.reset()
        outs, lat = answer(pred, requests, tag)
        counts, s8 = launches.read(), launches.s8()
        want = {k: per_batch.get(k, 0) * batches for k in counts}
        want_s8 = len(pred._int8_chains or {}) * batches
        if counts != want or s8 != want_s8:
            raise AssertionError(f"{tag}: launches {counts}, {s8} emitting s8; expected {want}, "
                                 f"{want_s8} emitting s8 ({per_batch} per batch)")
        total = {k: total[k] + counts[k] for k in total}
        print(f"{tag}: requests of {[len(r) for r in requests]} images answered in "
              f"{[round(t * 1e3, 2) for t in lat]} ms; launches {counts}, {s8} K4 and K5 "
              f"launches emitting s8, over {batches} batches")

        def copy_calibration(cpu):
            cpu._act_scales = dict(pred._act_scales)
            cpu._int8_chains = dict(pred._int8_chains) if pred._int8_chains else None
            cpu._rebuild()

        batches_out = [(pred.preprocess(r), o) for r, o in zip(requests, outs)]
        match_cpu_int8(Predictor, pred, kw, batches_out[1:] + batches_out[:1], tag,
                       setup=copy_calibration if tier == "calibrated" else None,
                       exact=int8_free_running(model_type, variant))
        for b, x in xs.items():
            ms = forward_ms(pred.model, x, tag)
            if tier == "dynamic":
                forward_ms(fp32, x, f"serve fp32 {name} (same run)")
            profile_split(tag, pred.model, x, ms)
    return total


def serve_int8_backbones(Predictor, launches, get_model, init_params):
    """The int8 paths past ResNet18: ResNet50 and ViT-Tiny +
    texture_nfp and MobileNetV3 + gap_only and multi_stage_nfp
    (``serve_int8``; MobileNetV3's BatchNorm statistics recalibrated).
    Returns the launches."""
    total = None
    for (model_type, variant), seed in zip(list(INT8_PATHS)[1:], range(40, 44)):
        with tempfile.TemporaryDirectory() as d:
            checkpoint = None
            if model_type == "mobilenetv3":
                checkpoint = os.path.join(d, "weights.pt")
                seeded_weights(get_model, init_params, model_type, variant, checkpoint)
            counts = serve_int8(Predictor, launches, model_type, variant, checkpoint, seed)
        total = counts if total is None else {k: total[k] + counts[k] for k in total}
    return total


def int8_layer_calls(model_type, variant):
    """int8 layer calls per forward of a registry pair, as the JAX
    interceptor replaces them (tests/test_torch_int8_models.py holds the
    port to the same table on all 63 pairs)."""
    if variant == "texture_nfp_intermediate":
        return 2
    if variant in ("nfp_insert", "mid_nfp", "multi_stage_nfp"):
        return 37
    base = dict(resnet18=20, resnet50=53, mobilenetv3=36, vittiny=49)[model_type]
    if variant == "texture_fractal":
        return base + 1
    if variant == "se_gate":
        return base + 4
    if variant in ("gap_mlp", "nfp_conv_mlp", "gap_nfp_conv_mlp_concat",
                   "gap_nfp_noconv_mlp_concat", "nfp_head", "multi_radius_nfp",
                   "adaptive_fusion_nfp"):
        return base + 2
    return base


def int8_heads(Predictor, launches, get_model, init_params):
    """One batch of 8 at 224 px through a dynamic int8 ``Predictor`` for
    every pair of the registry that ``INT8_PATHS`` leaves out (seeded
    weights, BatchNorm statistics recalibrated), against the CPU int8
    ``Predictor``: K4 runs each int8 linear and 1x1 conv call and K5 each
    other int8 conv call, as forward hooks count them, and their sum is
    ``int8_layer_calls``. Returns the launches."""
    from neighbour_feature_pooling_tpu_torch.models import MODEL_VARIANTS
    from neighbour_feature_pooling_tpu_torch.quant import Int8Conv2d, Int8Linear
    x = np.random.default_rng(35).standard_normal((8, 224, 224, 3)).astype(np.float32)
    total = dict(nfp_small=0, nfp_large=0, nfp_strip=0, int8_gemm=0, int8_conv=0)
    pairs = [(mt, v) for mt, vs in MODEL_VARIANTS.items() for v in vs
             if (mt, v) not in INT8_PATHS]
    for model_type, variant in pairs:
        tag = f"int8 heads {model_type}/{variant}"
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "weights.pt")
            seeded_weights(get_model, init_params, model_type, variant, path)
            kw = dict(model_type=model_type, model_variant=variant, num_classes=21,
                      batch_size=8, input_size=224, quantize="int8", checkpoint=path)
            pred = Predictor(**kw, device="cuda")
        calls = dict(int8_gemm=0, int8_conv=0)

        def count(mod, args):
            gemm = isinstance(mod, Int8Linear) or mod.gemm
            calls["int8_gemm" if gemm else "int8_conv"] += 1

        hooks = [m.register_forward_pre_hook(count) for m in pred.model.modules()
                 if isinstance(m, (Int8Conv2d, Int8Linear))]
        launches.reset()
        out = pred.predict(x, preprocessed=True)
        counts = launches.read()
        for h in hooks:
            h.remove()
        want = int8_layer_calls(model_type, variant)
        if (counts["int8_gemm"], counts["int8_conv"]) != (calls["int8_gemm"], calls["int8_conv"]) \
                or sum(calls.values()) != want:
            raise AssertionError(f"{tag}: K4 {counts['int8_gemm']} and K5 {counts['int8_conv']} "
                                 f"launches for {calls} int8 layer calls; expected {want} calls")
        if not np.isfinite(out["probabilities"]).all():
            raise AssertionError(f"{tag}: non-finite probabilities")
        print(f"{tag}: launches {counts} for {want} int8 layer calls")
        match_cpu_int8(Predictor, pred, kw, [(x, out)], tag,
                       exact=int8_free_running(model_type, variant))
        total = {k: total[k] + counts[k] for k in total}
        del pred
    print(f"int8 heads: {len(pairs)} pairs ran: " + ", ".join(f"{mt}/{v}" for mt, v in pairs))
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
                                       nfp_flops(m, positions, positions * 8, r["C"]))
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


#: a gradient error below this fraction of a tensor's largest gradient is
#: the rounding of fp32 sums taken in another order (cuBLAS, cuDNN and the
#: CPU differ), where the card-to-CPU ratio says nothing
FP32_ROUNDING = 1e-6


def _grad_errors(grads, exact):
    """Per tensor, max |g - exact| over max |exact|, the latter floored at
    1e-6 of the largest |exact| of all tensors: a bias that feeds a
    train-mode BatchNorm has a gradient of exactly zero, which fp32 reads
    as rounding noise."""
    floor = 1e-6 * max(float(v.abs().max()) for v in exact.values())
    return {n: float((g.double() - exact[n]).abs().max()) / max(float(exact[n].abs().max()),
                                                                floor)
            for n, g in grads.items()}


#: noise seeds of the perturbed copies of the parity batch (each pixel moved
#: by 1e-7 of itself), for a step that is chaotic at fp32 rounding
PERTURBED_SEEDS = (13, 14, 15, 16, 17)


def _parity_batch(seed=None):
    """The parity batch (21 classes, 224 px, B=8), or its copy with each
    pixel moved by 1e-7 of itself with noise of ``seed``."""
    rng = np.random.default_rng(12)
    image = rng.standard_normal((8, 224, 224, 3))
    label = torch.from_numpy(rng.integers(0, 21, 8))
    if seed is not None:
        image = image * (1 + 1e-7 * np.random.default_rng(seed).standard_normal(image.shape))
    return {"image": torch.from_numpy(image.astype(np.float32)), "label": label,
            "weight": torch.ones(8)}


def _parity_step(launches, engine, get_model, model_type, variant, want, host, tag,
                 fp32_limited_stats):
    """One train step of fresh seeded models on the card, on the CPU in fp32
    and on the CPU in fp64 on ``host``: checks the launches, the loss, the
    head's gradients and the BatchNorm statistics of the card against the
    CPU's fp32 step, and returns every tensor's gradient error against the
    fp64 step for the card and the CPU."""
    states = {}
    for dev, dtype in (("cpu", torch.float32), ("cuda", torch.float32), ("fp64", torch.float64)):
        model = get_model(model_type, variant, 21).to(device="cpu" if dev == "fp64" else dev,
                                                      memory_format=torch.channels_last)
        states[dev] = engine.create_train_state(model, 11, 1e-3)
        model.to(dtype)
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
    cpu_sd = states["cpu"].model.state_dict()
    exact_sd = states["fp64"].model.state_dict()
    stat_err, past = 0.0, []
    for name, v in states["cuda"].model.state_dict().items():
        if name.endswith(("running_mean", "running_var")):
            if not torch.allclose(v.cpu(), cpu_sd[name], rtol=1e-5, atol=1e-5):
                card_e = float((v.cpu().double() - exact_sd[name]).abs().max())
                cpu_e = float((cpu_sd[name].double() - exact_sd[name]).abs().max())
                if (not name.startswith(fp32_limited_stats) or card_e > 2 * cpu_e
                        or torch.allclose(cpu_sd[name].double(), exact_sd[name], rtol=1e-5,
                                          atol=1e-5)):
                    raise AssertionError(f"{tag}: {name} differs from the CPU's beyond 1e-5 "
                                         f"(against fp64: card {card_e:.3e}, CPU {cpu_e:.3e})")
                past.append(f"{name} card {card_e:.3e} / CPU {cpu_e:.3e} off fp64")
            stat_err = max(stat_err, float((v.cpu() - cpu_sd[name]).abs().max()))
    return dict(counts=counts, loss=float(loss), loss_err=loss_err, head_err=head_err,
                stat_err=stat_err, past=past, cpu_s=cpu_s, card_err=_grad_errors(card, exact),
                cpu_err=_grad_errors(cpu, exact))


def train_parity(launches, engine, get_model, model_type, variant, want, perturbed=(),
                 fp32_limited_stats=()):
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
    the fp64 step at most twice the CPU's fp32 step's, or than
    ``FP32_ROUNDING`` where the CPU's is below it (a model as well
    conditioned as ViT-Tiny, whose errors are all rounding).

    With ``perturbed`` noise seeds, the same again on each perturbed copy
    of the batch (``_parity_batch``), each device against an fp64 step on
    that copy, for a model whose step is chaotic at fp32 rounding: one
    ReLU unit within ~1e-6 of 0 (MobileNetV3 + multi_radius_nfp's
    compress, or one in the backbone) falls on either side of it on one
    rounding, and moves the median error from ~1e-5 to 5e-4-3e-3 on the
    card and on the CPU alike, batch by batch
    (``tools/train_parity_probe.py``). The card is then held to the CPU's
    spread over the same batches: its smallest largest-and-median error
    at most twice the CPU's smallest, and its greatest at most twice the
    CPU's greatest. ``fp32_limited_stats`` names the BatchNorm statistics
    (by prefix) that fp32 cannot compute to 1e-5 on either device
    (DeepTEN's ``bn``, fed by a softmax over logits of a few hundred): one
    of them past 1e-5 of the CPU's passes where the CPU's own is past 1e-5
    of the fp64 step's, within twice the CPU's error against it."""
    tag = f"train parity {model_type} + {variant}"
    seeds = (None,) + tuple(perturbed)
    steps = [_parity_step(launches, engine, get_model, model_type, variant, want,
                          _parity_batch(seed), tag, fp32_limited_stats) for seed in seeds]
    summary = {}
    for stat, fn in (("max", max), ("median", lambda v: float(np.median(list(v))))):
        card = [fn(s["card_err"].values()) for s in steps]
        cpu = [fn(s["cpu_err"].values()) for s in steps]
        summary[stat] = (card, cpu)
        for pick, word in ((min, "smallest"), (max, "greatest")):
            if pick(card) > 2 * max(pick(cpu), FP32_ROUNDING):
                raise AssertionError(
                    f"{tag}: {stat} gradient error against the fp64 step {pick(card):.3e} "
                    f"({word} over {len(steps)} batches), above twice the CPU fp32 step's "
                    f"{pick(cpu):.3e} (floored at {FP32_ROUNDING})")
    first = steps[0]
    worst = max(first["card_err"], key=first["card_err"].get)
    past = sorted({p for s in steps for p in s["past"]})
    stat_note = ("; past it, within twice the CPU's error against fp64: " + "; ".join(past)
                 if past else "")
    errs = lambda v: "/".join(f"{e:.3e}" for e in v)
    batches = (f" over the batch and {len(perturbed)} copies perturbed by 1e-7 (seeds "
               f"{', '.join(map(str, perturbed))}), each against fp64 on that batch"
               if perturbed else "")
    counts = {k: sum(s["counts"][k] for s in steps) for k in first["counts"]}
    print(f"{tag}: {len(steps)} train step(s), card against CPU (CPU fp32 step "
          f"{first['cpu_s']:.2f} s): loss {first['loss']:.6f}, |dloss| "
          f"{errs(s['loss_err'] for s in steps)} (<= 1e-4); head grads within "
          f"{max(s['head_err'] for s in steps):.3e} of each tensor's max (<= 1e-4); BatchNorm "
          f"running stats within {max(s['stat_err'] for s in steps):.3e} (<= 1e-5{stat_note}); "
          f"every grad against the CPU fp64 step, relative to each tensor's max{batches}: card "
          f"max {errs(summary['max'][0])} ({worst} first), median {errs(summary['median'][0])}; "
          f"CPU fp32 max {errs(summary['max'][1])}, median {errs(summary['median'][1])} ("
          + ("the card's smallest and greatest at most 2x the CPU's" if perturbed
             else "the card's at most 2x") + f"); launches {counts}")
    return counts


def train_rate(engine, get_model, nfp_reference, device_profile_fn, model_type="resnet18"):
    """Backbone + texture_nfp train steps at full width on batches resident
    on the card: img/s, peak memory, the step's split and its device share."""
    name = {"resnet18": "ResNet18", "resnet50": "ResNet50", "vittiny": "ViT-Tiny"}[model_type]
    for b in (32, 128):
        model = get_model(model_type, "texture_nfp", 21).to(
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
            fmap = head_map(model, batch["image"])
        xg = fmap.detach().requires_grad_(True)
        g = torch.randn((b, 8), generator=gen, device="cuda")

        def nfp_backward():
            return torch.autograd.grad(nfp_reference(xg, 1, "cosine", padding=1, fuse_gap=True),
                                       xg, g)

        nfp_bwd_ms = _events_ms(nfp_backward)
        print(f"train rate: {name} + texture_nfp, 21 classes, 224 px, B={b}, fp32 (TF32 off): "
              f"{step_ms:.3f} ms/step = {b / step_ms * 1e3:.1f} img/s (median of 20 after 3, "
              f"CUDA events); peak memory {peak:.2f} GiB; forward + loss {fwd_ms:.3f} ms, "
              f"backward {fwd_bwd_ms - fwd_ms:.3f} ms (forward + backward {fwd_bwd_ms:.3f}), "
              f"Adam {opt_ms:.3f} ms; the NFP backward alone (plain recompute + autograd on "
              f"{tuple(fmap.shape)}) {nfp_bwd_ms:.3f} ms = {nfp_bwd_ms / step_ms:.1%} of the "
              f"step")
        busy, n_kernels, by_name = device_profile_fn(lambda: engine.train_step(state, batch, 21))
        if not n_kernels:
            print(f"train rate {name} B={b}: torch.profiler recorded no device events: "
                  f"device time not measured")
            continue
        print(f"train rate {name} B={b}: torch.profiler: {n_kernels:.0f} kernels per step, "
              f"{busy:.3f} ms of device time per step ({1 - busy / step_ms:.1%} of the "
              f"{step_ms:.3f} ms step idle); most time: " + top3(by_name))
        del model, state, batch, fmap, xg
        torch.cuda.empty_cache()


def train_rate_heads(engine, get_model):
    """ResNet18 train steps at B=32 with each head of the texture-heads
    phase that trains differently from texture_nfp (dropout on the fractal
    and gap_mlp heads, DeepTEN's recomputed distances, RADAM's frozen
    RAEs), beside texture_nfp's, on batches resident on the card."""
    times = {}
    for variant in ("texture_nfp", "texture_fractal", "texture_lacunarity", "texture_deepten",
                    "texture_radam", "gap_mlp"):
        model = get_model("resnet18", variant, 21).to(device="cuda",
                                                     memory_format=torch.channels_last)
        state = engine.create_train_state(model, 13, 1e-4)
        if state.dropout_generator().device.type != "cuda":
            raise AssertionError(f"train rate heads: {variant}'s dropout generator is not on "
                                 f"the card")
        gen = torch.Generator(device="cuda").manual_seed(14)
        batch = {"image": torch.randn((32, 224, 224, 3), generator=gen, device="cuda"),
                 "label": torch.randint(0, 21, (32,), generator=gen, device="cuda"),
                 "weight": torch.ones(32, device="cuda")}
        times[variant] = _events_ms(lambda: engine.train_step(state, batch, 21))
        if not np.isfinite(float(engine.train_step(state, batch, 21)[0])):
            raise AssertionError(f"train rate heads: {variant}'s loss is not finite")
        del model, state, batch
        torch.cuda.empty_cache()
    print("train rate heads: ResNet18, 21 classes, 224 px, B=32, fp32 (TF32 off), ms/step "
          "(median of 20 after 3, CUDA events; dropout masks drawn on the card): "
          + ", ".join(f"{v} {ms:.3f}" for v, ms in times.items()))


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


def phase(name, fn, *args, **kwargs):
    """Run one phase and print its wall seconds."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    print(f"phase {name}: {time.perf_counter() - t0:.2f} s")
    return out


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
    from neighbour_feature_pooling_tpu_torch.models import get_model, init_params
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
    rows = dict(nfp_small=phase("kernels K1", check_kernel, nfp_small_cuda, k1_cases(),
                                "serve B=32 float32 fuse_gap=True", nfp_reference,
                                num_neighbors, nfp_output_size, note=k1_plan,
                                parent=parent and parent.nfp_small_cuda))
    print("kernels: nfp_large (K2) against nfp_reference on the card "
          "(fp32 rtol=atol=1e-5; bf16 within one bf16 ulp)")
    rows["nfp_large"] = phase("kernels K2", check_kernel, nfp_large_cuda, k2_cases(), K2_MAIN,
                              nfp_reference, num_neighbors, nfp_output_size,
                              note=k2_plan, parent=parent and parent.nfp_large_cuda)
    print("kernels: nfp_strip (K3) against nfp_reference on the card "
          "(fp32 rtol=atol=1e-5; bf16 within one bf16 ulp)")
    rows["nfp_strip"] = phase("kernels K3", check_kernel, nfp_strip_cuda, k3_cases(), K3_MAIN,
                              nfp_reference, num_neighbors, nfp_output_size,
                              note=k2_plan, parent=parent and parent.nfp_strip_cuda)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"serve: torch.backends.cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"torch.backends.cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    rows.update(phase("kernels K4 and K5", check_int8_kernels, int8_gemm, int8_gemm_reference,
                      pack_weight, int8_conv2d, int8_conv2d_reference, pack_conv_weight))
    launches = Launches(nfp_small=nfp_small_cuda, nfp_large=nfp_large_cuda,
                        nfp_strip=nfp_strip_cuda, int8_gemm=int8_gemm, int8_conv=int8_conv2d)
    per_path = [phase("serve resnet18", serve_texture_nfp, Predictor, launches),
                phase("serve mobilenetv3", serve_mobilenetv3, Predictor, launches, gap2d, nfp)]
    phase("other mobilenetv3 variants", other_mobilenetv3_variants, Predictor, launches)
    per_path.append(phase("serve resnet50", serve_texture_nfp, Predictor, launches,
                          "resnet50", seed=20))
    per_path.append(phase("serve vittiny", serve_texture_nfp, Predictor, launches,
                          "vittiny", seed=22))
    per_path.append(phase("nfp_at_layer", nfp_at_layer, Predictor, launches))
    per_path.append(phase("texture heads", texture_heads, Predictor, launches, get_model,
                          init_params))
    per_path.append(phase("serve resnet18 int8", serve_int8, Predictor, launches, "resnet18",
                          "texture_nfp"))
    per_path.append(phase("serve int8 backbones", serve_int8_backbones, Predictor, launches,
                          get_model, init_params))
    per_path.append(phase("int8 heads", int8_heads, Predictor, launches, get_model, init_params))
    per_path.append(phase("kernel entry", kernel_entry, launches, bench_nfp_kernel, nfp_kernel,
                          nfp_reference))
    none = dict(nfp_small=0, nfp_large=0, nfp_strip=0, int8_gemm=0, int8_conv=0)
    for model_type, variant, want in (
            ("resnet18", "texture_nfp", dict(none, nfp_small=1)),
            ("mobilenetv3", "multi_stage_nfp", dict(none, nfp_small=2, nfp_large=3)),
            ("resnet50", "texture_nfp", dict(none, nfp_small=1)),
            ("vittiny", "texture_nfp", dict(none, nfp_small=1)),
            ("resnet18", "texture_deepten", none),
            ("resnet18", "texture_radam", none),
            ("mobilenetv3", "multi_radius_nfp", dict(none, nfp_small=2))):
        kw = {"texture_deepten": dict(fp32_limited_stats=("bn.",)),
              "multi_radius_nfp": dict(perturbed=PERTURBED_SEEDS)}.get(variant, {})
        per_path.append(phase(f"train parity {model_type} {variant}", train_parity, launches,
                              engine, get_model, model_type, variant, want, **kw))
    for model_type in ("resnet18", "resnet50", "vittiny"):
        phase(f"train rate {model_type}", train_rate, engine, get_model, nfp_reference,
              device_profile, model_type)
    phase("train rate heads", train_rate_heads, engine, get_model)
    per_path.append(phase("train cli", train_cli, launches, cli, Predictor))
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
