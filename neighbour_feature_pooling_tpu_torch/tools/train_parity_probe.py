"""Where a one-step train parity's gradient leaves the fp64 step's.

    python -m neighbour_feature_pooling_tpu_torch.tools.train_parity_probe \\
        [--model_type mobilenetv3] [--variant multi_radius_nfp] \\
        [--seeds 0,13,14,15,16,17]

For each seed, the batch of ``chip_smoke.py``'s ``train_parity`` (21
classes, 224 px, B=8; seed 0) or its copy with each pixel moved by 1e-7 of
itself with noise of that seed, one train step of freshly seeded models on
the card, on the CPU in fp32 and on the CPU in fp64 on that batch. Per
device against the fp64 step: every tensor's gradient error relative to
its largest magnitude (largest and median over tensors); the head's input
and its output gradient; the head's input gradient; for a head with a
``compress`` (1x1 conv + BatchNorm + ReLU), the gradient at the compress
input and the ReLU units that fall on the other side of 0 than in fp64;
for one with ``se_gate1``, the same for the gate's ReLU. Then the head's
input gradient from an fp64 copy of the head at the device's own head
input and output gradient: equal to the device's, the head computed what
it was given as well as fp64 would; equal to the fp64 step's, the inputs'
rounding did not move it. Needs a card; prints one block per seed.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..models import get_model
from ..train import engine


def _state(model_type, variant, device, dtype):
    model = get_model(model_type, variant, 21).to(device=device,
                                                  memory_format=torch.channels_last)
    state = engine.create_train_state(model, 11, 1e-3)
    model.to(dtype)
    return state


def _hooked_step(state, batch):
    """One train step, with the head's tensors and gradients recorded."""
    model = state.model
    head = getattr(model, model.head_name)
    rec, handles = {}, []

    def keep(key):
        return lambda t: rec.__setitem__(key, t.detach().cpu().double())

    def on_head(module, inputs, out):
        rec["x"] = inputs[0].detach().cpu().double()
        inputs[0].register_hook(keep("dx"))
        out.register_hook(keep("gout"))

    def on_compress(module, inputs, out):
        inputs[0].register_hook(keep("gcat"))

    # a forward hook that returns a value replaces the module's output
    handles.append(head.register_forward_hook(on_head))
    if hasattr(head, "compress"):
        handles.append(head.compress.register_forward_hook(on_compress))
        handles.append(head.compress.bn.register_forward_hook(
            lambda m, i, o: keep("prerelu")(o)))
    if hasattr(head, "se_gate1"):
        handles.append(head.se_gate1.register_forward_hook(lambda m, i, o: keep("se1")(o)))
    loss, _ = engine.train_step(state, batch, 21)
    for h in handles:
        h.remove()
    rec["loss"] = float(loss)
    rec["grads"] = {n: p.grad.cpu().double() for n, p in model.named_parameters()}
    return rec


def _rel(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def _grad_errors(grads, exact):
    """Per tensor, max |g - exact| over max |exact| (floored at 1e-6 of the
    largest |exact| of all tensors), as ``chip_smoke._grad_errors``."""
    floor = 1e-6 * max(float(v.abs().max()) for v in exact.values())
    return [float((g - exact[n]).abs().max()) / max(float(exact[n].abs().max()), floor)
            for n, g in grads.items()]


def _head_input_grad(model_type, variant, x, gout):
    """The head's input gradient in fp64 on the CPU, from the seeded
    weights, at head input ``x`` and output gradient ``gout``."""
    model = _state(model_type, variant, "cpu", torch.float64).model
    head = getattr(model, model.head_name).train()
    xx = x.clone().requires_grad_(True)
    (dx,) = torch.autograd.grad(head(xx), xx, gout)
    return dx


def _batch(seed):
    rng = np.random.default_rng(12)
    image = rng.standard_normal((8, 224, 224, 3))
    label = torch.from_numpy(rng.integers(0, 21, 8))
    if seed:
        image = image * (1 + 1e-7 * np.random.default_rng(seed).standard_normal(image.shape))
    return {"image": torch.from_numpy(image.astype(np.float32)), "label": label,
            "weight": torch.ones(8)}


def probe(model_type, variant, seeds):
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    for seed in seeds:
        t0 = time.perf_counter()
        host = _batch(seed)
        recs = {
            "card": _hooked_step(_state(model_type, variant, "cuda", torch.float32),
                                 {k: v.cuda() for k, v in host.items()}),
            "cpu": _hooked_step(_state(model_type, variant, "cpu", torch.float32), host),
            "fp64": _hooked_step(_state(model_type, variant, "cpu", torch.float64), dict(
                host, image=host["image"].double(), weight=host["weight"].double())),
        }
        exact = recs["fp64"]
        lines = [f"seed {seed}:"]
        for dev in ("card", "cpu"):
            r = recs[dev]
            errs = _grad_errors(r["grads"], exact["grads"])
            parts = [f"{dev} grads max {max(errs):.3e} median {float(np.median(errs)):.3e}",
                     f"head input {_rel(r['x'], exact['x']):.2e}",
                     f"head output grad {_rel(r['gout'], exact['gout']):.2e}",
                     f"head input grad {_rel(r['dx'], exact['dx']):.2e}"]
            if "gcat" in r:
                flips = int(((r["prerelu"] > 0) != (exact["prerelu"] > 0)).sum())
                parts.append(f"compress input grad {_rel(r['gcat'], exact['gcat']):.2e}")
                parts.append(f"compress ReLU flips {flips} (smallest |pre-ReLU| in fp64 "
                             f"{float(exact['prerelu'].abs().min()):.1e})")
            if "se1" in r:
                parts.append(f"se_gate1 ReLU flips "
                             f"{int(((r['se1'] > 0) != (exact['se1'] > 0)).sum())}")
            dx64 = _head_input_grad(model_type, variant, r["x"], r["gout"])
            parts.append(f"head input grad against an fp64 head at its own input and output "
                         f"grad {_rel(r['dx'], dx64):.2e}, that against the fp64 step's "
                         f"{_rel(dx64, exact['dx']):.2e}")
            lines.append("; ".join(parts))
        print("\n  ".join(lines), f"({time.perf_counter() - t0:.1f} s)", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model_type", default="mobilenetv3")
    ap.add_argument("--variant", default="multi_radius_nfp")
    ap.add_argument("--seeds", default="0,13,14,15,16,17",
                    help="0 is the batch itself, others perturbed copies")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("train_parity_probe needs a CUDA card")
    probe(args.model_type, args.variant, [int(s) for s in args.seeds.split(",")])


if __name__ == "__main__":
    main()
