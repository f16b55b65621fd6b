"""Shared building blocks: norms, dense layers in a compute dtype, dropout,
reference attention, initializers.

Parameters are fp32, or bf16 where the trainer stores a frozen tower in
bf16. A module's compute dtype (flax's module ``dtype``) casts the inputs
and weights of its matrix products, as flax's ``promote_dtype`` does; norms
keep fp32 statistics and weights whatever the parameters' dtype (as flax
promotes a bf16 weight against fp32 statistics) and return their input's
dtype. The port uses explicit dtypes, not ``torch.autocast``: autocast would
keep the residual stream in fp32 where the reference's is in the compute
dtype."""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

# Large-negative additive mask value. Finite (not -inf) so that fully-masked
# rows softmax to uniform instead of NaN.
NEG_INF = -1e9


class RMSNorm(nn.Module):
    """T5-style RMS LayerNorm: no mean subtraction, no bias. Variance in
    fp32, fp32 weight, result cast back to the input dtype."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        var = x32.square().mean(-1, keepdim=True)
        y = x32 * torch.rsqrt(var + self.eps)
        return (y * self.weight.float()).to(x.dtype)

    def init_weights(self, generator: torch.Generator) -> None:
        nn.init.ones_(self.weight)


class LayerNorm(nn.Module):
    """Standard LayerNorm (SwinV2) with fp32 statistics."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), (x.shape[-1],), self.weight.float(),
                         self.bias.float(), self.eps)
        return y.to(x.dtype)

    def init_weights(self, generator: torch.Generator) -> None:
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)


class Dense(nn.Linear):
    """``nn.Linear`` whose product runs in ``compute_dtype``: input, weight
    and bias are cast to it (flax ``nn.Dense(dtype=...)``), whatever the
    parameters' dtype."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability ``1 - rate``, scale the
    kept values by ``1 / (1 - rate)`` formed in x's dtype. The mask comes
    from the explicit ``generator`` (on x's device), never from the global
    one. Rate 0 is the identity."""
    if rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout at rate > 0 needs a generator")
    keep_prob = 1.0 - rate
    keep = torch.rand(x.shape, generator=generator, device=x.device) < keep_prob
    # A fill on the device, not a copy from the host: a copy would wait
    # for the device to drain.
    scale = torch.full((), keep_prob, dtype=x.dtype, device=x.device)
    return torch.where(keep, x / scale, torch.zeros((), dtype=x.dtype,
                                                    device=x.device))


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bias: Optional[torch.Tensor] = None,
                          dropout_rate: float = 0.0,
                          generator: Optional[torch.Generator] = None
                          ) -> torch.Tensor:
    """Reference attention, q,k,v (B, H, L, D): no 1/sqrt(d) scale (T5
    folds it into the init), fp32 logits and softmax, probabilities cast to
    the input dtype, then dropped (``dropout``, at ``dropout_rate``) in that
    dtype, then multiplied by v with an fp32 sum."""
    dtype = q.dtype
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
    if bias is not None:
        logits = logits + bias.float()
    probs = dropout(torch.softmax(logits, dim=-1).to(dtype), dropout_rate,
                    generator)
    return torch.matmul(probs.float(), v.float()).to(dtype)


def mlp_block(x: torch.Tensor, fc1: nn.Linear, fc2: nn.Linear,
              gelu_approximate: bool = False) -> torch.Tensor:
    """The JAX package's ``MlpBlock`` (SwinV2 FFN), deterministic:
    ``fc2(gelu(fc1(x)))`` (the GELU in fc1's output dtype). The two layers
    belong to the calling block so that they carry HF's Swinv2 names
    (``intermediate.dense``, ``output.dense``)."""
    h = F.gelu(fc1(x), approximate="tanh" if gelu_approximate else "none")
    return fc2(h)


# ---------------------------------------------------------------------------
# Initializers matching the JAX package's flax initializers
# ---------------------------------------------------------------------------


def normal_(t: torch.Tensor, std: float, generator: torch.Generator) -> None:
    with torch.no_grad():
        t.normal_(0.0, std, generator=generator)


def lecun_normal_(t: torch.Tensor, fan_in: int,
                  generator: torch.Generator) -> None:
    """flax ``lecun_normal``: truncated normal on [-2, 2] standard
    deviations, scaled so the variance is 1 / fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                          generator=generator)


def init_linear_(layer: nn.Linear, generator: torch.Generator) -> None:
    """flax ``nn.Dense`` default: lecun-normal kernel, zero bias."""
    lecun_normal_(layer.weight, layer.in_features, generator)
    if layer.bias is not None:
        nn.init.zeros_(layer.bias)
