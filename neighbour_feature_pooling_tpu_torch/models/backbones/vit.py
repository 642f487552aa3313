"""ViT-Tiny/16 backbone (counterpart of ``neighbour_feature_pooling_tpu/
models/backbones/vit.py``; timm geometry).

16×16 conv patch embed → prepend CLS → add the learned position embedding
→ 12 pre-norm transformer blocks (dim 192, 3 heads, MLP ratio 4, exact
GELU, LayerNorm eps 1e-6) → final LayerNorm → ``(B, 1+N, D)`` tokens.
``tokens_to_map`` drops CLS and reshapes the patch tokens to an NHWC map.

Submodule names are timm's (``patch_embed.proj``, ``cls_token``,
``pos_embed``, ``blocks.i.{norm1,attn.qkv,attn.proj,norm2,mlp.fc1,
mlp.fc2}``, ``norm``), so reference and timm ``state_dict`` keys load with
no key map. ``attn.qkv`` is one ``(3D, D)`` Linear, queries first, then
keys, then values; queries are scaled by ``Dh**-0.5`` before QKᵀ.

An input other than 224 px resamples the 14×14 grid of the position
embedding bilinearly with antialiasing, as ``jax.image.resize`` does when
it shrinks. The JAX module pads the token sequence with zero rows to a
multiple of 8 (``seq_align``; 197 → 200 at 224 px) and masks the padded
keys with −1e9, whose softmax weight is exactly 0 in fp32: a TPU layout
choice, which leaves the fp32 tokens as they are. Here attention runs over
the real 1+N tokens unless ``seq_align`` > 1. The int8 tier sets it to the
JAX value (``quant.py``): the pad rows flow through every LayerNorm and
projection, so they enter each per-tensor activation amax, and on some
weights they set it.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["Attention", "Block", "ViT", "vit_tiny_patch16_224", "tokens_to_map"]

PATCH = 16  # pixels per patch side
GRID = 14   # patches per side of the position embedding (224 px)


def _layer_norm(dim: int) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=1e-6)


class Attention(nn.Module):
    """Multi-head self-attention with one fused QKV projection."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, key_mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """``key_mask``: ``(1, T)`` bool, False for the keys no query attends to."""
        b, t, d = x.shape
        h = self.num_heads
        hd = d // h
        q, k, v = (u.reshape(b, t, h, hd).transpose(1, 2)
                   for u in self.qkv(x).split(d, dim=-1))
        y = F.scaled_dot_product_attention(q * hd ** -0.5, k, v, attn_mask=key_mask,
                                           scale=1.0)
        return self.proj(y.transpose(1, 2).reshape(b, t, d))


class Mlp(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, 4 * dim)  # MLP ratio 4
        self.fc2 = nn.Linear(4 * dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))  # exact GELU, as the JAX MlpBlock


class Block(nn.Module):
    """Pre-norm transformer block: x + attn(norm1(x)), then + mlp(norm2(·))."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.norm1 = _layer_norm(dim)
        self.attn = Attention(dim, num_heads)
        self.norm2 = _layer_norm(dim)
        self.mlp = Mlp(dim)

    def forward(self, x: torch.Tensor, key_mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        x = x + self.attn(self.norm1(x), key_mask)
        return x + self.mlp(self.norm2(x))


class _PatchEmbed(nn.Module):
    def __init__(self, in_chans: int, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(in_chans, dim, PATCH, stride=PATCH)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC images → ``(B, gh, gw, D)`` patch embeddings."""
        return self.proj(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class ViT(nn.Module):
    """Vision Transformer feature extractor: NHWC images in, ``(B, 1+N, D)``
    tokens out. ViT-Tiny is the default width, depth and head count."""

    def __init__(self, in_chans: int = 3, embed_dim: int = 192, depth: int = 12,
                 num_heads: int = 3):
        super().__init__()
        #: > 1 pads the blocks' sequence with zero rows to a multiple of it, as
        #: the JAX module does (module docstring); the int8 tier sets it. The
        #: pad rows are stripped before the final norm, a per-row op.
        self.seq_align = 1
        self.patch_embed = _PatchEmbed(in_chans, embed_dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + GRID * GRID, embed_dim))
        self.blocks = nn.Sequential(*(Block(embed_dim, num_heads) for _ in range(depth)))
        self.norm = _layer_norm(embed_dim)

    def _pos_embed(self, gh: int, gw: int) -> torch.Tensor:
        pos = self.pos_embed
        if (gh, gw) == (GRID, GRID):
            return pos
        grid = pos[:, 1:].reshape(1, GRID, GRID, -1).permute(0, 3, 1, 2)
        grid = F.interpolate(grid, size=(gh, gw), mode="bilinear", align_corners=False,
                             antialias=True)
        return torch.cat([pos[:, :1], grid.permute(0, 2, 3, 1).reshape(1, gh * gw, -1)], dim=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.patch_embed(x)
        b, gh, gw, d = x.shape
        x = torch.cat([self.cls_token.expand(b, 1, d), x.reshape(b, gh * gw, d)], dim=1)
        x = x + self._pos_embed(gh, gw)
        t = x.shape[1]
        pad = -t % self.seq_align if self.seq_align > 1 else 0
        key_mask = None
        if pad:
            x = F.pad(x, (0, 0, 0, pad))
            key_mask = (torch.arange(t + pad, device=x.device) < t)[None]
        for blk in self.blocks:
            x = blk(x, key_mask)
        return self.norm(x[:, :t])


def tokens_to_map(tokens: torch.Tensor) -> torch.Tensor:
    """Drop CLS and reshape the patch tokens to an NHWC map:
    ``(B, 1+N, D)`` → ``(B, √N, √N, D)``; N must be a perfect square."""
    patches = tokens[:, 1:]
    b, n, d = patches.shape
    h = round(n ** 0.5)
    if h * h != n:
        raise ValueError(f"token count {n} is not a perfect square")
    return patches.reshape(b, h, h, d)


def vit_tiny_patch16_224(in_chans: int = 3) -> ViT:
    return ViT(in_chans=in_chans)
