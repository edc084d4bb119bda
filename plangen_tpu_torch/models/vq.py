"""LlamaGen VQ-16 image tokenizer as PyTorch modules.

Port of `plangen_tpu/models/vq.py`: the decoder (`conv2d`, `group_norm`,
`swish`, `resblock`, `attnblock`, `upsample_nearest2x`, `decoder_forward`,
`_normalized_codebook`, `decode_code`, `decode_code_uint8`) and the encoder
side (`downsample`, `encoder_forward`, `quant_conv`, `quantize`,
`encode_to_indices`), which gives the training labels of the image flows.
Module names follow HF Janus `VQModel` (`decoder.conv_blocks.{i}.res.{j}`,
`encoder.conv_blocks.{i}.downsample.conv`, `decoder.mid.{0,1,2}`,
`quantize.embedding`, `quant_conv`, `post_quant_conv`).

The public functions keep the JAX package's NHWC layout; inside, tensors
are channels-first, PyTorch's own layout. Numerics mirror the JAX package:
convs cast their input to the weight dtype, GroupNorm runs in fp32, the
codebook stays fp32 and is l2-normalised on lookup, and the mid-block
attention is a plain fp32-accumulated matmul.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from plangen_tpu_torch.config import VQConfig


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def upsample_nearest2x(x: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] -> [B, C, 2H, 2W], each pixel repeated 2x2."""
    return F.interpolate(x, scale_factor=2.0, mode="nearest")


class Conv2d(nn.Conv2d):
    """Stride-1 'SAME' conv; the input is cast to the weight dtype."""

    def __init__(self, cin: int, cout: int, k: int, dtype=None, device=None):
        super().__init__(cin, cout, k, padding=k // 2, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.to(self.weight.dtype))


class GroupNorm(nn.GroupNorm):
    """GroupNorm computed in fp32, output in the input dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.group_norm(
            x.float(), self.num_groups, self.weight.float(), self.bias.float(),
            self.eps,
        )
        return out.to(x.dtype)


def _group_norm(c: int, cfg: VQConfig, dtype, device) -> GroupNorm:
    return GroupNorm(cfg.group_norm_groups, c, eps=cfg.group_norm_eps,
                     dtype=dtype, device=device)


class ResnetBlock(nn.Module):
    def __init__(self, cin: int, cout: int, cfg: VQConfig, dtype=None, device=None):
        super().__init__()
        self.norm1 = _group_norm(cin, cfg, dtype, device)
        self.conv1 = Conv2d(cin, cout, 3, dtype, device)
        self.norm2 = _group_norm(cout, cfg, dtype, device)
        self.conv2 = Conv2d(cout, cout, 3, dtype, device)
        if cin != cout:
            self.nin_shortcut = Conv2d(cin, cout, 1, dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(swish(self.norm1(x)))
        h = self.conv2(swish(self.norm2(h)))
        if hasattr(self, "nin_shortcut"):
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head spatial self-attention over the H*W pixels."""

    def __init__(self, c: int, cfg: VQConfig, dtype=None, device=None):
        super().__init__()
        self.norm = _group_norm(c, cfg, dtype, device)
        self.q = Conv2d(c, c, 1, dtype, device)
        self.k = Conv2d(c, c, 1, dtype, device)
        self.v = Conv2d(c, c, 1, dtype, device)
        self.proj_out = Conv2d(c, c, 1, dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        h = self.norm(x)
        q = self.q(h).reshape(B, C, H * W).transpose(1, 2)  # [B, HW, C]
        k = self.k(h).reshape(B, C, H * W)  # [B, C, HW]
        v = self.v(h).reshape(B, C, H * W).transpose(1, 2)
        logits = torch.bmm(q.float(), k.float())  # [B, HW, HW]
        probs = torch.softmax(logits * C ** -0.5, dim=-1)
        out = torch.bmm(probs.to(v.dtype).float(), v.float()).to(x.dtype)
        out = out.transpose(1, 2).reshape(B, C, H, W)
        return x + self.proj_out(out)


class Upsample(nn.Module):
    def __init__(self, c: int, dtype=None, device=None):
        super().__init__()
        self.conv = Conv2d(c, c, 3, dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(upsample_nearest2x(x))


class DecoderLevel(nn.Module):
    def __init__(self):
        super().__init__()
        self.res = nn.ModuleList()
        self.attn = nn.ModuleList()


class Decoder(nn.Module):
    """Levels run deepest-first: (num_res_blocks + 1) ResnetBlocks each,
    attention at the deepest, an upsample after every level but the last."""

    def __init__(self, cfg: VQConfig, dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        n_levels = len(cfg.ch_mult)
        block_in = cfg.ch * cfg.ch_mult[-1]
        self.conv_in = Conv2d(cfg.z_channels, block_in, 3, **kw)
        self.mid = nn.ModuleList([
            ResnetBlock(block_in, block_in, cfg, **kw),
            AttnBlock(block_in, cfg, **kw),
            ResnetBlock(block_in, block_in, cfg, **kw),
        ])
        self.conv_blocks = nn.ModuleList()
        c = block_in
        for i_level in reversed(range(n_levels)):
            level = DecoderLevel()
            cout = cfg.ch * cfg.ch_mult[i_level]
            for _ in range(cfg.num_res_blocks + 1):
                level.res.append(ResnetBlock(c, cout, cfg, **kw))
                c = cout
                if i_level == n_levels - 1:
                    level.attn.append(AttnBlock(c, cfg, **kw))
            if i_level != 0:
                level.upsample = Upsample(c, **kw)
            self.conv_blocks.append(level)
        self.norm_out = _group_norm(c, cfg, dtype, device)
        self.conv_out = Conv2d(c, cfg.out_channels, 3, **kw)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(z)
        for block in self.mid:
            h = block(h)
        for level in self.conv_blocks:
            for b, res in enumerate(level.res):
                h = res(h)
                if len(level.attn):
                    h = level.attn[b](h)
            if hasattr(level, "upsample"):
                h = level.upsample(h)
        return self.conv_out(swish(self.norm_out(h)))


class VectorQuantizer(nn.Module):
    """Holds the codebook (kept fp32: lookups are precision-sensitive)."""

    def __init__(self, cfg: VQConfig, device=None):
        super().__init__()
        self.embedding = nn.Embedding(
            cfg.codebook_size, cfg.codebook_dim, dtype=torch.float32, device=device
        )


class Downsample(nn.Module):
    """Pad the bottom and right by one pixel, then a 3x3 stride-2 conv."""

    def __init__(self, c: int, dtype=None, device=None):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3, stride=2, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.pad(x.to(self.conv.weight.dtype), (0, 1, 0, 1)))


class EncoderLevel(nn.Module):
    def __init__(self):
        super().__init__()
        self.res = nn.ModuleList()
        self.attn = nn.ModuleList()


class Encoder(nn.Module):
    """Levels run shallowest-first: num_res_blocks ResnetBlocks each,
    attention at the deepest, a downsample after every level but the last;
    then mid = res, attn, res and GroupNorm + swish + conv_out."""

    def __init__(self, cfg: VQConfig, dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        n_levels = len(cfg.ch_mult)
        in_mult = (1,) + tuple(cfg.ch_mult)
        self.conv_in = Conv2d(3, cfg.ch, 3, **kw)
        self.conv_blocks = nn.ModuleList()
        c = cfg.ch
        for i in range(n_levels):
            level = EncoderLevel()
            c = cfg.ch * in_mult[i]
            cout = cfg.ch * cfg.ch_mult[i]
            for _ in range(cfg.num_res_blocks):
                level.res.append(ResnetBlock(c, cout, cfg, **kw))
                c = cout
                if i == n_levels - 1:
                    level.attn.append(AttnBlock(c, cfg, **kw))
            if i != n_levels - 1:
                level.downsample = Downsample(c, **kw)
            self.conv_blocks.append(level)
        self.mid = nn.ModuleList([
            ResnetBlock(c, c, cfg, **kw), AttnBlock(c, cfg, **kw), ResnetBlock(c, c, cfg, **kw),
        ])
        self.norm_out = _group_norm(c, cfg, dtype, device)
        self.conv_out = Conv2d(c, cfg.z_channels, 3, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x)
        for level in self.conv_blocks:
            for b, res in enumerate(level.res):
                h = res(h)
                if len(level.attn):
                    h = level.attn[b](h)
            if hasattr(level, "downsample"):
                h = level.downsample(h)
        for block in self.mid:
            h = block(h)
        return self.conv_out(swish(self.norm_out(h)))


class VQModel(nn.Module):
    """`VQModel`: encoder -> quant_conv -> nearest code, and codebook ->
    post_quant_conv -> decoder."""

    def __init__(self, cfg: VQConfig, dtype=None, device=None):
        super().__init__()
        self.cfg = cfg
        self.decoder = Decoder(cfg, dtype, device)
        self.quantize = VectorQuantizer(cfg, device)
        self.post_quant_conv = Conv2d(cfg.codebook_dim, cfg.z_channels, 1, dtype, device)
        self.encoder = Encoder(cfg, dtype, device)
        self.quant_conv = Conv2d(cfg.z_channels, cfg.codebook_dim, 1, dtype, device)

    def normalized_codebook(self) -> torch.Tensor:
        cb = self.quantize.embedding.weight.float()
        if self.cfg.l2_norm:
            cb = cb / cb.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        return cb

    def decode_code(
        self, indices: torch.Tensor, grid_hw: Tuple[int, int]
    ) -> torch.Tensor:
        """VQ token ids [B, N] -> images [B, H, W, 3] (NHWC)."""
        B = indices.shape[0]
        gh, gw = grid_hw
        z_q = self.normalized_codebook()[indices.reshape(-1)]
        z_q = z_q.reshape(B, gh, gw, -1).permute(0, 3, 1, 2)
        img = self.decoder(self.post_quant_conv(z_q))
        return img.permute(0, 2, 3, 1)

    def decode_code_uint8(
        self, indices: torch.Tensor, grid_hw: Tuple[int, int]
    ) -> torch.Tensor:
        """decode_code + uint8 conversion on the device, truncating like the
        JAX package's `clip((x + 1) * 127.5, 0, 255).astype(uint8)`."""
        img = self.decode_code(indices, grid_hw).float()
        return ((img + 1.0) * 127.5).clamp(0, 255).to(torch.uint8)

    def quantize_latents(self, z: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """z [B, e, h, w] -> (z_q [B, h, w, e] fp32, indices [B, h*w]): both z
        and the codebook l2-normalised, the nearest code by squared distance
        |z|^2 + |e|^2 - 2 z.e (first index on ties), as `vq.quantize`."""
        B, e, h, w = z.shape
        zf = z.float().permute(0, 2, 3, 1).reshape(B * h * w, e)
        if self.cfg.l2_norm:
            zf = zf / zf.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        cb = self.normalized_codebook()
        d = ((zf * zf).sum(dim=1, keepdim=True) + (cb * cb).sum(dim=1)[None, :]
             - 2.0 * (zf @ cb.T))
        idx = d.argmin(dim=1)
        return cb[idx].reshape(B, h, w, e), idx.reshape(B, h * w)

    def encode_to_indices(self, images: torch.Tensor) -> torch.Tensor:
        """images [B, H, W, 3] (NHWC, in [-1, 1]) -> VQ token ids [B, (H/16)*(W/16)]."""
        h = self.quant_conv(self.encoder(images.permute(0, 3, 1, 2)))
        return self.quantize_latents(h)[1]
