"""SwinV2 vision encoder (HF ``Swinv2Model`` equivalent), deterministic.

Patch embedding, four stages of shifted-window attention with the v2
changes (scaled-cosine attention with a learned clamped logit scale,
log-spaced continuous relative-position-bias MLP, residual-post-norm), patch
merging, and the final LayerNorm producing ``last_hidden_state``. Parameters
carry HF's Swinv2 names so a state dict from ``checkpoint/from_jax.py``
loads with ``strict=True``. ``dtype`` is the compute dtype of the patch
embedding and of every dense layer (flax's module dtype); the continuous
position bias MLP and the norms' statistics run in fp32 whatever the
parameters' dtype (bf16 when the tower is frozen and stored in bf16). The
tower runs deterministically (no drop-path, no attention dropout) in
training too, trainable or not, as the JAX package runs it.

With ``use_pallas`` every window attention goes through the hand-written
kernel (``ops.fused_attention.swin_attention``, with its recompute backward
when the tower trains); otherwise it runs the reference form, which
normalizes q and k by ``max(||x||, 1e-12)``.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import SwinV2Size
from ..ops.fused_attention import LOG_MAX_SCALE, swin_attention
from ..utils.device import resolve_device
from .layers import Dense, LayerNorm, init_linear_, lecun_normal_, mlp_block

# ---------------------------------------------------------------------------
# Static tables
# ---------------------------------------------------------------------------


def log_cpb_coords(window_size: int, pretrained_window_size: int = 0
                   ) -> np.ndarray:
    """Log-spaced normalized relative coordinate table, ((2w-1)^2, 2) fp32
    (HF Swinv2SelfAttention's ``relative_coords_table``)."""
    w = window_size
    h = np.arange(-(w - 1), w, dtype=np.float32)
    grid = np.stack(np.meshgrid(h, h, indexing="ij"), axis=-1)  # (2w-1,2w-1,2)
    denom = (pretrained_window_size - 1 if pretrained_window_size > 0
             else w - 1)
    grid = grid / max(denom, 1)
    grid = grid * 8.0
    grid = np.sign(grid) * np.log2(np.abs(grid) + 1.0) / np.log2(8.0)
    return grid.reshape(-1, 2)


def relative_position_index(window_size: int) -> np.ndarray:
    """(w*w, w*w) indices into the (2w-1)^2 bias table (standard Swin)."""
    w = window_size
    coords = np.stack(np.meshgrid(np.arange(w), np.arange(w), indexing="ij"))
    coords = coords.reshape(2, -1)  # (2, w*w)
    rel = coords[:, :, None] - coords[:, None, :]  # (2, w*w, w*w)
    rel = rel.transpose(1, 2, 0)
    rel[:, :, 0] += w - 1
    rel[:, :, 1] += w - 1
    rel[:, :, 0] *= 2 * w - 1
    return rel.sum(-1)


def shifted_window_mask(height: int, width: int, window_size: int,
                        shift_size: int) -> np.ndarray:
    """(nW, w*w, w*w) additive mask for shifted windows, 0 or -100 (HF
    Swinv2's ``get_attn_mask`` fill value; the cosine logits are bounded, so
    -100 fully suppresses them)."""
    w, s = window_size, shift_size
    img = np.zeros((height, width), np.int32)
    cnt = 0
    for hs in (slice(0, -w), slice(-w, -s), slice(-s, None)):
        for ws in (slice(0, -w), slice(-w, -s), slice(-s, None)):
            img[hs, ws] = cnt
            cnt += 1
    wins = img.reshape(height // w, w, width // w, w).transpose(0, 2, 1, 3)
    wins = wins.reshape(-1, w * w)  # (nW, w*w)
    diff = wins[:, None, :] - wins[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


def window_partition(x: torch.Tensor, window_size: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * nW, w*w, C)."""
    B, H, W, C = x.shape
    w = window_size
    x = x.view(B, H // w, w, W // w, w, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, w * w, C)


def window_reverse(x: torch.Tensor, window_size: int, height: int,
                   width: int) -> torch.Tensor:
    """(B * nW, w*w, C) -> (B, H, W, C)."""
    w = window_size
    C = x.shape[-1]
    B = x.shape[0] // (height // w * (width // w))
    x = x.view(B, height // w, width // w, w, w, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, height, width, C)


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------


class WindowAttention(nn.Module):
    """SwinV2 scaled-cosine window attention with log-CPB (HF's
    ``attention.self``). Takes pre-partitioned windows (B*nW, w*w, C) and
    the static shifted-window mask (nW, w*w, w*w) or None; returns the
    merged heads before the output projection, which HF names
    ``attention.output.dense`` and the block holds."""

    def __init__(self, dim: int, num_heads: int, window_size: int,
                 pretrained_window_size: int = 0, qkv_bias: bool = True,
                 use_pallas: bool = False,
                 softmax_dtype: torch.dtype = torch.float32,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.use_pallas = use_pallas
        self.softmax_dtype = softmax_dtype
        self.dtype = dtype
        self.logit_scale = nn.Parameter(torch.empty(num_heads, 1, 1))
        self.continuous_position_bias_mlp = nn.Sequential(
            nn.Linear(2, 512, bias=True), nn.ReLU(),
            nn.Linear(512, num_heads, bias=False))
        self.query = Dense(dim, dim, bias=qkv_bias, compute_dtype=dtype)
        self.key = Dense(dim, dim, bias=False, compute_dtype=dtype)
        self.value = Dense(dim, dim, bias=qkv_bias, compute_dtype=dtype)
        # torch.tensor (not from_numpy) so the tables follow the device the
        # model is built under.
        self.register_buffer("relative_coords_table", torch.tensor(
            log_cpb_coords(window_size, pretrained_window_size),
            dtype=torch.float32), persistent=False)
        self.register_buffer("relative_position_index", torch.tensor(
            relative_position_index(window_size).reshape(-1),
            dtype=torch.long), persistent=False)

    def init_weights(self, generator: torch.Generator) -> None:
        nn.init.constant_(self.logit_scale, math.log(10.0))
        for layer in (self.continuous_position_bias_mlp[0],
                      self.continuous_position_bias_mlp[2], self.query,
                      self.key, self.value):
            init_linear_(layer, generator)

    def position_bias(self, N: int) -> torch.Tensor:
        """Continuous relative position bias, (H, N, N) fp32: a tiny MLP
        over the static log-spaced table, then 16*sigmoid (v2 bounding). The
        MLP runs in fp32 whatever its parameters' dtype, as the JAX
        package's ``nn.Dense(dtype=float32)`` promotes them."""
        fc1, _, fc2 = self.continuous_position_bias_mlp
        cpb = F.linear(self.relative_coords_table, fc1.weight.float(),
                       fc1.bias.float())
        cpb = F.linear(F.relu(cpb), fc2.weight.float())
        bias = cpb[self.relative_position_index].view(N, N, -1)
        return (16.0 * torch.sigmoid(bias)).permute(2, 0, 1).contiguous()

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        Bn, N, C = x.shape
        H = self.num_heads

        def heads(t):
            return t.view(Bn, N, H, C // H).transpose(1, 2)

        q = heads(self.query(x))
        k = heads(self.key(x))
        v = heads(self.value(x))
        bias_h = self.position_bias(N)
        scale = self.logit_scale.view(H)
        if self.use_pallas:
            # The kernel takes an fp32 scale (exact for bf16 parameters).
            out = swin_attention(q.contiguous(), k.contiguous(),
                                 v.contiguous(), scale.float(), bias_h, mask,
                                 softmax_dtype=self.softmax_dtype)
        else:
            out = self._reference_attention(q, k, v, scale, bias_h, mask)
        return out.transpose(1, 2).reshape(Bn, N, C)

    def _reference_attention(self, q, k, v, scale, bias_h, mask):
        """Cosine attention of the JAX package's unflagged branch:
        normalize by max(||x||, 1e-12) in fp32 and cast to the compute
        dtype, scale by the clamped learned temperature, softmax in
        ``softmax_dtype``, probabilities cast to the compute dtype before
        the product with v."""
        sm, dt = self.softmax_dtype, self.dtype
        q32 = q.float()
        k32 = k.float()
        q32 = q32 / torch.clamp(torch.linalg.vector_norm(
            q32, dim=-1, keepdim=True), min=1e-12)
        k32 = k32 / torch.clamp(torch.linalg.vector_norm(
            k32, dim=-1, keepdim=True), min=1e-12)
        logits = torch.matmul(q32.to(dt).float(),
                              k32.to(dt).float().transpose(-1, -2)).to(sm)
        s = torch.exp(torch.clamp(scale, max=LOG_MAX_SCALE))
        logits = logits * s[None, :, None, None].to(sm)
        logits = logits + bias_h[None].to(sm)
        if mask is not None:
            Bn, H, N, _ = logits.shape
            nW = mask.shape[0]
            logits = (logits.view(Bn // nW, nW, H, N, N)
                      + mask.to(sm)[None, :, None]).view(Bn, H, N, N)
        probs = torch.softmax(logits, dim=-1)
        return torch.matmul(probs.to(dt).float(), v.float()).to(dt)


class SwinV2Block(nn.Module):
    """One SwinV2 layer: shifted-window attention + MLP, residual-post-norm
    (the norm is applied to each sublayer's output before the residual
    add)."""

    def __init__(self, dim: int, num_heads: int, input_resolution: int,
                 window_size: int, shift_size: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, layer_norm_eps: float = 1e-5,
                 pretrained_window_size: int = 0, use_pallas: bool = False,
                 softmax_dtype: torch.dtype = torch.float32,
                 gelu_approximate: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        R = self.input_resolution = input_resolution
        # Shrink the window when the feature map is no larger than it
        # (HF _compute_window_shift): the 8x8 final stage at 256 px.
        self.window_size = R if R <= window_size else window_size
        self.shift_size = 0 if R <= window_size else shift_size
        self.gelu_approximate = gelu_approximate
        self.attention = nn.ModuleDict({
            "self": WindowAttention(
                dim, num_heads, self.window_size, pretrained_window_size,
                qkv_bias, use_pallas, softmax_dtype, dtype),
            "output": nn.ModuleDict({"dense": Dense(dim, dim,
                                                    compute_dtype=dtype)}),
        })
        self.layernorm_before = LayerNorm(dim, layer_norm_eps)
        hidden = int(dim * mlp_ratio)
        self.intermediate = nn.ModuleDict({"dense": Dense(
            dim, hidden, compute_dtype=dtype)})
        self.output = nn.ModuleDict({"dense": Dense(hidden, dim,
                                                    compute_dtype=dtype)})
        self.layernorm_after = LayerNorm(dim, layer_norm_eps)
        mask = None
        if self.shift_size > 0:
            mask = torch.tensor(shifted_window_mask(
                R, R, self.window_size, self.shift_size))
        self.register_buffer("attn_mask", mask, persistent=False)

    def init_weights(self, generator: torch.Generator) -> None:
        self.attention["self"].init_weights(generator)
        for layer in (self.attention["output"]["dense"],
                      self.intermediate["dense"], self.output["dense"]):
            init_linear_(layer, generator)
        self.layernorm_before.init_weights(generator)
        self.layernorm_after.init_weights(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        R, w, s = self.input_resolution, self.window_size, self.shift_size
        B, L, C = x.shape
        shortcut = x
        h = x.view(B, R, R, C)
        if s > 0:
            h = torch.roll(h, (-s, -s), dims=(1, 2))
        attn = self.attention["self"](window_partition(h, w), self.attn_mask)
        attn = self.attention["output"]["dense"](attn)
        h = window_reverse(attn, w, R, R)
        if s > 0:
            h = torch.roll(h, (s, s), dims=(1, 2))
        h = self.layernorm_before(h.reshape(B, L, C))
        x = shortcut + h
        h = mlp_block(x, self.intermediate["dense"], self.output["dense"],
                      self.gelu_approximate)
        return x + self.layernorm_after(h)


class PatchMerging(nn.Module):
    """2x2 patch merge: concat -> Linear(4C->2C) -> LayerNorm (v2 order)."""

    def __init__(self, dim: int, layer_norm_eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.reduction = Dense(4 * dim, 2 * dim, bias=False,
                               compute_dtype=dtype)
        self.norm = LayerNorm(2 * dim, layer_norm_eps)

    def init_weights(self, generator: torch.Generator) -> None:
        init_linear_(self.reduction, generator)
        self.norm.init_weights(generator)

    def forward(self, x: torch.Tensor, resolution: int) -> torch.Tensor:
        B, L, C = x.shape
        R = resolution
        h = x.view(B, R, R, C)
        # HF concat order: (0::2,0::2), (1::2,0::2), (0::2,1::2), (1::2,1::2)
        parts = [h[:, 0::2, 0::2], h[:, 1::2, 0::2],
                 h[:, 0::2, 1::2], h[:, 1::2, 1::2]]
        h = torch.cat(parts, dim=-1).reshape(B, (R // 2) ** 2, 4 * C)
        return self.norm(self.reduction(h))


class SwinV2Encoder(nn.Module):
    """Swinv2Model equivalent: images -> (B, tokens, num_features).

    Input is channels-last ``(B, H, W, 3)``, as in the JAX package; it is
    permuted to channels-first for the patch-embedding convolution.
    ``dtype``: the compute dtype. ``device``: None means the card (see
    ``utils.device``).
    """

    def __init__(self, size: SwinV2Size, use_pallas: bool = False,
                 softmax_dtype: torch.dtype = torch.float32,
                 gelu_approximate: bool = False,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        with torch.device(resolve_device(device)):
            cfg = self.size = size
            self.dtype = dtype
            p = cfg.patch_size
            self.embeddings = nn.ModuleDict({
                "patch_embeddings": nn.ModuleDict({"projection": nn.Conv2d(
                    cfg.num_channels, cfg.embed_dim, p, stride=p)}),
                "norm": LayerNorm(cfg.embed_dim, cfg.layer_norm_eps),
            })
            R = cfg.image_size // p
            dim = cfg.embed_dim
            stages = []
            for si, depth in enumerate(cfg.depths):
                stage = nn.ModuleDict({"blocks": nn.ModuleList(
                    SwinV2Block(
                        dim, cfg.num_heads[si], R, cfg.window_size,
                        shift_size=0 if li % 2 == 0 else cfg.window_size // 2,
                        mlp_ratio=cfg.mlp_ratio, qkv_bias=cfg.qkv_bias,
                        layer_norm_eps=cfg.layer_norm_eps,
                        pretrained_window_size=cfg.pretrained_window_sizes[si],
                        use_pallas=use_pallas, softmax_dtype=softmax_dtype,
                        gelu_approximate=gelu_approximate, dtype=dtype)
                    for li in range(depth))})
                if si < len(cfg.depths) - 1:
                    stage["downsample"] = PatchMerging(
                        dim, cfg.layer_norm_eps, dtype)
                    R //= 2
                    dim *= 2
                stages.append(stage)
            self.encoder = nn.ModuleDict({"layers": nn.ModuleList(stages)})
            self.layernorm = LayerNorm(dim, cfg.layer_norm_eps)

    def init_weights(self, generator: torch.Generator) -> None:
        proj = self.embeddings["patch_embeddings"]["projection"]
        lecun_normal_(proj.weight, proj.weight[0].numel(), generator)
        nn.init.zeros_(proj.bias)
        self.embeddings["norm"].init_weights(generator)
        for stage in self.encoder["layers"]:
            for blk in stage["blocks"]:
                blk.init_weights(generator)
            if "downsample" in stage:
                stage["downsample"].init_weights(generator)
        self.layernorm.init_weights(generator)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        proj = self.embeddings["patch_embeddings"]["projection"]
        dt = self.dtype
        x = F.conv2d(pixel_values.permute(0, 3, 1, 2).to(dt),
                     proj.weight.to(dt), proj.bias.to(dt), stride=proj.stride)
        B, C, R, _ = x.shape
        x = self.embeddings["norm"](x.flatten(2).transpose(1, 2))
        for stage in self.encoder["layers"]:
            for blk in stage["blocks"]:
                x = blk(x)
            if "downsample" in stage:
                x = stage["downsample"](x, R)
                R //= 2
        return self.layernorm(x)
