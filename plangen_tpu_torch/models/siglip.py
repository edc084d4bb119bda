"""SigLIP-Large ViT understanding tower as PyTorch modules.

Port of `plangen_tpu/models/siglip.py`: patch-embed conv 16x16 with bias,
learned position embeddings, no class token, pre-norm blocks (LayerNorm eps
1e-6 in fp32, qkv with bias, exact GELU), final LayerNorm; the attention-pool
head is not built. Module names follow the timm VisionTransformer inside HF
Janus (`vision_model.vision_tower.blocks.{i}.attn.qkv`, ...), so the
exported `vision_model.*` keys load as they are.

Images come in NHWC (the JAX package's layout) and are made channels-first
inside. `use_flash` sends each block's non-causal attention to the flash
kernel (`ops/flash_attention.py`) with an all-ones key mask; the kernel takes
576 patches as they are (the JAX package pads them to 640 for its 128-row
tiles). `remat` runs each block under `ops/remat.py`, as the JAX package
wraps its block-scan body in `jax.checkpoint`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from plangen_tpu_torch.config import SigLIPConfig
from plangen_tpu_torch.ops.attention import dot_product_attention
from plangen_tpu_torch.ops.flash_attention import flash_attention
from plangen_tpu_torch.ops.remat import Remat, remat_call


class LayerNorm(nn.LayerNorm):
    """LayerNorm computed in fp32, output in the input dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.layer_norm(x.float(), self.normalized_shape, self.weight.float(),
                           self.bias.float(), self.eps)
        return out.to(x.dtype)


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int, dtype=None, device=None):
        super().__init__()
        self.head_dim = dim // heads
        self.qkv = nn.Linear(dim, 3 * dim, dtype=dtype, device=device)
        self.proj = nn.Linear(dim, dim, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor, use_flash: bool = False) -> torch.Tensor:
        B, N, D = x.shape
        # the heads this rank holds: all of them, or heads/tp under TP
        qkv = self.qkv(x).reshape(B, N, 3, -1, self.head_dim)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        if use_flash:
            mask = torch.ones((B, N), dtype=torch.int32, device=x.device)
            attn = flash_attention(q, k, v, mask, causal=False)
        else:
            attn = dot_product_attention(q, k, v)
        return self.proj(attn.reshape(B, N, -1))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, dtype=None, device=None):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden, dtype=dtype, device=device)
        self.fc2 = nn.Linear(hidden, dim, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    def __init__(self, cfg: SigLIPConfig, dtype=None, device=None):
        super().__init__()
        d = cfg.width
        self.norm1 = LayerNorm(d, eps=cfg.layer_norm_eps, dtype=dtype, device=device)
        self.attn = Attention(d, cfg.heads, dtype, device)
        self.norm2 = LayerNorm(d, eps=cfg.layer_norm_eps, dtype=dtype, device=device)
        self.mlp = Mlp(d, int(d * cfg.mlp_ratio), dtype, device)

    def forward(self, x: torch.Tensor, use_flash: bool = False) -> torch.Tensor:
        x = x + self.attn(self.norm1(x), use_flash)
        return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    def __init__(self, cfg: SigLIPConfig, dtype=None, device=None):
        super().__init__()
        p = cfg.patch_size
        self.proj = nn.Conv2d(3, cfg.width, p, stride=p, dtype=dtype, device=device)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """[B, H, W, 3] NHWC -> [B, N, width], patches in row-major order."""
        x = self.proj(images.permute(0, 3, 1, 2).to(self.proj.weight.dtype))
        return x.flatten(2).transpose(1, 2)


class VisionTransformer(nn.Module):
    def __init__(self, cfg: SigLIPConfig, dtype=None, device=None):
        super().__init__()
        self.patch_embed = PatchEmbed(cfg, dtype, device)
        self.pos_embed = nn.Parameter(
            torch.zeros((1, cfg.num_patches, cfg.width), dtype=dtype, device=device))
        self.blocks = nn.ModuleList(Block(cfg, dtype, device) for _ in range(cfg.layers))
        self.norm = LayerNorm(cfg.width, eps=cfg.layer_norm_eps, dtype=dtype, device=device)

    def forward(self, images: torch.Tensor, use_flash: bool = False,
                remat: Remat = False) -> torch.Tensor:
        """images [B, H, W, 3] (NHWC, CLIP-normalized) -> features [B, N, width]."""
        x = self.patch_embed(images)
        x = x + self.pos_embed.to(x.dtype)
        for block in self.blocks:
            x = remat_call(block, remat, x, use_flash)
        return self.norm(x)


class SigLIPVisionModel(nn.Module):
    """`vision_model` of HF Janus: the tower lives under `vision_tower`."""

    def __init__(self, cfg: SigLIPConfig, dtype=None, device=None):
        super().__init__()
        self.vision_tower = VisionTransformer(cfg, dtype, device)

    def forward(self, images: torch.Tensor, use_flash: bool = False,
                remat: Remat = False) -> torch.Tensor:
        return self.vision_tower(images, use_flash, remat)
