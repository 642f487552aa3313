"""Model summary: the ``torchinfo.summary`` the reference prints once per
run, as a per-module parameter-count table (counterpart of
``neighbour_feature_pooling_tpu/utils/summary.py``)."""

from __future__ import annotations

from typing import Dict

from torch import nn

__all__ = ["count_parameters", "summarize"]


def count_parameters(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def summarize(model: nn.Module, max_depth: int = 2) -> str:
    """Parameters per module, grouped by the first ``max_depth`` components
    of their names, then the trainable total and the BatchNorm running
    statistics (means and variances)."""
    groups: Dict[str, int] = {}
    for name, p in model.named_parameters():
        key = ".".join(name.split(".")[:-1][:max_depth]) or name
        groups[key] = groups.get(key, 0) + p.numel()
    width = max((len(k) for k in groups), default=10) + 2
    lines = [f"{'Module':<{width}}  Params", "=" * (width + 10)]
    for k in sorted(groups):
        lines.append(f"{k:<{width}}  {groups[k]:,}")
    n_stats = sum(b.numel() for name, b in model.named_buffers()
                  if name.endswith(("running_mean", "running_var")))
    lines.append("=" * (width + 10))
    lines.append(f"{'Total trainable':<{width}}  {count_parameters(model):,}")
    if n_stats:
        lines.append(f"{'BatchNorm stats':<{width}}  {n_stats:,}")
    return "\n".join(lines)
