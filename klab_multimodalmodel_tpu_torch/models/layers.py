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

import dataclasses
import math
from typing import Iterator, Optional

import torch
import torch.nn.functional as F
from torch import nn

# Large-negative additive mask value. Finite (not -inf) so that fully-masked
# rows softmax to uniform instead of NaN.
NEG_INF = -1e9


# ---------------------------------------------------------------------------
# Initializers matching the JAX package's flax initializers, as a plan
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Init:
    """One parameter's initializer: ``normal`` (std ``arg``),
    ``lecun_normal`` (flax's: a normal truncated at two standard deviations,
    scaled to variance 1 / fan_in, fan_in ``arg``), ``ones``, ``zeros``,
    ``constant`` (``arg``) or ``eye``. Called on a tensor, it fills it; the
    first two draw from the generator, and draw the same values into any
    contiguous tensor of one shape, dtype and device."""

    kind: str
    arg: float = 0.0

    @property
    def draws(self) -> bool:
        return self.kind in ("normal", "lecun_normal")

    def __call__(self, t: torch.Tensor, generator: torch.Generator) -> None:
        with torch.no_grad():
            if self.kind == "normal":
                t.normal_(0.0, self.arg, generator=generator)
            elif self.kind == "lecun_normal":
                std = math.sqrt(1.0 / self.arg) / 0.87962566103423978
                nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
            elif self.kind == "eye":
                t.zero_().diagonal().fill_(1.0)
            else:
                t.fill_(dict(ones=1.0, zeros=0.0).get(self.kind, self.arg))


# A module's init plan: (its state-dict name, initializer), in draw order.
Plan = Iterator[tuple[str, Init]]


class PlanInit:
    """A module whose init is a plan (``init_plan``: each parameter's name
    and ``Init``, in the order they draw from the generator):
    ``init_weights`` runs it into the module's own parameters. A rank that
    holds part of a parameter runs the same plan on whole temporaries and
    keeps its part (``train/trainer.py``), so its generator moves as one
    process's does."""

    def init_plan(self) -> Plan:
        raise NotImplementedError

    def init_weights(self, generator: torch.Generator) -> None:
        params = dict(self.named_parameters())
        for name, init in self.init_plan():
            init(params[name], generator)


def sub_plan(prefix: str, plan: Plan) -> Plan:
    """A submodule's ``plan`` under its name ``prefix``."""
    for name, init in plan:
        yield f"{prefix}.{name}", init


def linear_plan(layer: nn.Linear) -> Plan:
    """flax ``nn.Dense`` default: lecun-normal kernel, zero bias."""
    yield "weight", Init("lecun_normal", layer.in_features)
    if layer.bias is not None:
        yield "bias", Init("zeros")


class RMSNorm(PlanInit, nn.Module):
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

    def init_plan(self) -> Plan:
        yield "weight", Init("ones")


class LayerNorm(PlanInit, nn.Module):
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

    def init_plan(self) -> Plan:
        yield "weight", Init("ones")
        yield "bias", Init("zeros")


class Dense(nn.Linear):
    """``nn.Linear`` whose product runs in ``compute_dtype``: input, weight
    and bias are cast to it (flax ``nn.Dense(dtype=...)``), whatever the
    parameters' dtype.

    Row-parallel under tensor parallelism (a weight that is a DTensor split
    on its input features, ``parallel/partitioning.py``): each rank's
    partial product of the ``compute_dtype`` operands is formed in fp32,
    the partials are summed over the tensor group in fp32 and rounded once,
    as one process's product accumulates every input feature in fp32
    before its one rounding."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        if _row_parallel(self.weight):
            return _row_parallel_linear(x, self.weight, bias, dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


def _row_parallel(weight) -> bool:
    """Whether ``weight`` is a DTensor split on its input features (dim 1)
    over a one-dimensional mesh: a row-parallel layer's, as FSDP2 hands it
    to the forward."""
    from torch.distributed.tensor import DTensor, Shard

    return (isinstance(weight, DTensor) and weight.device_mesh.ndim == 1
            and weight.placements[0] == Shard(1))


def _row_parallel_linear(x, weight, bias, dt: torch.dtype):
    """The row-parallel product (see ``Dense``): ``x``, the rank's input
    features (a DTensor split on its last dim, or its local tensor), times
    its columns of ``weight``, summed over the weight's mesh in fp32,
    rounded to ``dt``; a replicated DTensor, as the layer's output hook
    expects."""
    from torch.distributed.tensor import DTensor, Replicate

    from ..parallel.partitioning import sum_over_group

    local = x.to_local() if isinstance(x, DTensor) else x
    partial = F.linear(local.to(dt).float(), weight.to_local().to(dt).float())
    y = sum_over_group(partial, weight.device_mesh.get_group()).to(dt)
    if bias is not None:
        y = y + (bias.to_local() if isinstance(bias, DTensor) else bias)
    return DTensor.from_local(y, weight.device_mesh, [Replicate()],
                              run_check=False)


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator],
            shard=None) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability ``1 - rate``, scale the
    kept values by ``1 / (1 - rate)`` formed in x's dtype. The mask comes
    from the explicit ``generator`` (on x's device), never from the global
    one. Rate 0 is the identity. ``shard`` = (dim, start, full): x is
    columns ``start ..`` of a tensor ``full`` wide on ``dim`` (a tensor
    rank's heads or d_ff columns), or a list of such triples on distinct
    dims (an MoE rank's experts and columns); the mask is drawn at the full
    width and sliced, so the rank keeps one process's mask and its
    generator moves as one process's does."""
    if rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout at rate > 0 needs a generator")
    keep_prob = 1.0 - rate
    if shard is None:
        keep = torch.rand(x.shape, generator=generator, device=x.device)
    else:
        shards = [shard] if isinstance(shard[0], int) else list(shard)
        shape = list(x.shape)
        for dim, _, full in shards:
            shape[dim] = full
        keep = torch.rand(shape, generator=generator, device=x.device)
        for dim, start, _ in shards:
            keep = keep.narrow(dim, start, x.shape[dim])
    keep = keep < keep_prob
    # A fill on the device, not a copy from the host: a copy would wait
    # for the device to drain.
    scale = torch.full((), keep_prob, dtype=x.dtype, device=x.device)
    return torch.where(keep, x / scale, torch.zeros((), dtype=x.dtype,
                                                    device=x.device))


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bias: Optional[torch.Tensor] = None,
                          dropout_rate: float = 0.0,
                          generator: Optional[torch.Generator] = None,
                          heads: Optional[tuple[int, int]] = None,
                          rows: Optional[tuple[int, int]] = None,
                          batch: Optional[tuple[int, int]] = None
                          ) -> torch.Tensor:
    """Reference attention, q,k,v (B, H, L, D): no 1/sqrt(d) scale (T5
    folds it into the init), fp32 logits and softmax, probabilities cast to
    the input dtype, then dropped (``dropout``, at ``dropout_rate``) in that
    dtype, then multiplied by v with an fp32 sum. ``heads`` = (first,
    total): q holds heads ``first ..`` of ``total`` (a tensor rank's), and
    the dropout mask is those heads' of one process; ``rows``, the same for
    query rows (a seq rank's), beside ``heads`` too (a tensor x seq rank's
    heads at its rows); ``batch``, the same for the batch rows (a data
    rank's share of a pipelined microbatch), beside either."""
    dtype = q.dtype
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
    if bias is not None:
        logits = logits + bias.float()
    shard = [(d, *part) for d, part in ((0, batch), (1, heads), (2, rows))
             if part is not None] or None
    probs = dropout(torch.softmax(logits, dim=-1).to(dtype), dropout_rate,
                    generator, shard)
    return torch.matmul(probs.float(), v.float()).to(dtype)


def mlp_block(x: torch.Tensor, fc1: nn.Linear, fc2: nn.Linear,
              gelu_approximate: bool = False) -> torch.Tensor:
    """The JAX package's ``MlpBlock`` (SwinV2 FFN), deterministic:
    ``fc2(gelu(fc1(x)))`` (the GELU in fc1's output dtype). The two layers
    belong to the calling block so that they carry HF's Swinv2 names
    (``intermediate.dense``, ``output.dense``)."""
    h = F.gelu(fc1(x), approximate="tanh" if gelu_approximate else "none")
    return fc2(h)
