"""T5 encoder-decoder (v1.0 and v1.1/Flan geometries).

The port of the JAX package's ``models/t5.py``: relative-position-bucket
attention bias, RMSNorm, ReLU or gated tanh-GELU MLPs, the tied LM head with
its ``d_model**-0.5`` scale (or an untied ``lm_head``), incremental decoding
against a KV cache, and the training forward (teacher-forced decoder,
``shift_right``, ``cross_entropy_loss``). Layers run as a Python loop.

Every module takes a compute dtype (``dtype``, flax's module dtype):
embeddings and matrix products run in it, the parameters stay fp32. With
``deterministic=False`` dropout runs where the JAX package places it (stack
input, each residual branch, after the MLP activation, after the final
norm, and on the attention probabilities), drawing from an explicit
``torch.Generator``.

Parameters carry HuggingFace's names (``encoder.block.{i}.layer.0.
SelfAttention.q.weight``, ...), so a state dict from
``checkpoint/from_jax.py`` loads with ``strict=True``. Tied copies that HF
also lists (``encoder.embed_tokens``, a tied ``lm_head``) are not stored
twice.

With ``use_pallas`` a stack routes its full-sequence attention through the
hand-written kernels (``ops.fused_attention.t5_attention``: forward, and the
backward when a gradient is needed), passing the (H, Q, K) head bias and the
(B, K) key mask straight to them; the probabilities are dropped inside the
kernel. Decode steps never take the kernels.

``remat`` ('full' or 'dots_saveable') checkpoints each block of
``T5ForConditionalGeneration``'s two stacks, as the JAX package wraps its
scanned blocks: the backward recomputes the block's forward. The recompute
replays the step generator's state from before the block, so it draws the
forward's dropout masks and kernel seeds again, and leaves the generator
where the forward left it (``torch.utils.checkpoint`` restores only the
default generators).

``moe_experts > 0`` replaces every MLP of ``T5ForConditionalGeneration``'s
stacks with a Switch / GShard mixture of experts (``T5MoeMlp``, routing in
``ops/moe.py``): a block then returns ``(x, aux)``, a stack sums its blocks'
balance losses, and ``forward`` adds ``moe_aux_loss_weight`` times the sum
of both stacks' to the loss. The stack's key mask is also the routing mask
(pads route nowhere); a decode step routes its chunk with no mask, at the
capacity of the chunk's length, as the JAX package's does. With an
``aux_group`` (``set_aux_group``: the ranks that hold the other rows) a
stack's balance loss is this rank's share of the mean over every rank's
groups (``ops/moe.py`` ``balance_share``), as the JAX package takes one
mean over the global batch.

Under tensor parallelism (``parallel/partitioning.py``, a ``tensor`` mesh
axis above 1) each rank holds its heads' q/k/v/o columns and its d_ff
columns of the MLP, or of every expert of its MoE banks
(``T5Stack.set_tensor_shard``, then ``split_experts``): attention runs the
rank's heads on their rows of the head bias, the kernels key their
dropout on the global head (``head_offset``), and the MLP's and the plain
attention's dropout masks are drawn at the full width and sliced, so every
rank's masks are one process's. The relative-position table stays whole on
every rank; each reads its heads' columns.

Under sequence parallelism (a ``seq`` mesh axis above 1,
``T5Stack.set_seq_group``) each rank of a seq group runs positions
``s L / S ..`` of every stack whose length L divides by S, as the JAX
package's ``seq_constraint`` pins every stack's input and every block's
carry to the ``seq`` axis; a stack whose length does not divide runs whole
on every rank. Self-attention gathers K/V over the group
(``seq_gather``), or with ``--seq_attention ring`` streams them around it
(``ops/ring_attention.py``); the bias rows are the rank's
(``T5Stack.position_bias``), the kernels key their dropout on the global
query (``q_offset``), and the other dropout masks are drawn at the full
length and sliced. Beside tensor parallelism a rank runs its heads at its
rows: the bias rows are its heads' (``_local_heads``), and the kernels and
the ring key their dropout on both the global head and the global query.
An encoder stack gathers its output (the cross-attention
context and the text tower's features are whole on every rank); the
decoder keeps its rows, and ``forward``'s loss is the mean over the rank's
positions. Under MoE a seq rank routes its positions at the capacity of
the full length, its slots offset by the earlier seq ranks' choices
(``ops/moe.py``), and its balance loss is its positions' share of the
whole; a stack that runs whole on every seq rank counts its balance loss
on seq rank 0 only. Decode steps never shard.

``pipeline_stages > 1`` runs a stack's full-sequence forward as the JAX
package's GPipe schedule (``T5Stack._pipelined``): S stages of consecutive
blocks, M microbatches, M + S - 1 ticks. On one rank the schedule reorders
work and changes no value. The layers keep their names, so a pipelined
model's state dict is a plain one: checkpoints carry no stage count. Each
(stage, microbatch) draws its dropout from a generator of its own, keyed
on the step generator's state, so that no mask depends on the order in
which stages run. Under a ``pipe`` mesh axis (``T5ForConditionalGeneration.
split_stages``) a rank holds one stage's blocks and runs that stage,
shifting microbatches to the next stage's rank
(``parallel/partitioning.py`` ``pipe_stages``).

Under an ``expert`` mesh axis (``T5ForConditionalGeneration.
split_experts``) each ``T5MoeMlp`` holds its rank's slice of the expert
banks and runs those experts (``ops/moe.py``); routing stays whole and the
same on every rank.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import math
import re
from typing import Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint as ckpt
from torch import nn

from ..config import T5Size
from ..ops.fused_attention import draw_seed, t5_attention
from ..ops.moe import balance_share, moe_capacity, moe_ffn, topk_routing
from ..ops.ring_attention import ring_applicable, ring_self_attention
from ..parallel.partitioning import (ExpertGroup, PipeGroup, gather_columns,
                                     pipe_stages, seq_gather, seq_shard,
                                     tied_logits)
from ..utils.device import resolve_device
from .layers import (NEG_INF, Dense, Init, Plan, PlanInit, RMSNorm,
                     dot_product_attention, dropout, sub_plan)

# A decode cache: one dict per layer, {"self": {...}, "cross": {...}}.
Cache = list


# ---------------------------------------------------------------------------
# Relative position bias
# ---------------------------------------------------------------------------


def relative_position_bucket(relative_position: torch.Tensor,
                             bidirectional: bool = True,
                             num_buckets: int = 32,
                             max_distance: int = 128) -> torch.Tensor:
    """T5's log-spaced relative-position bucketing (``key_pos -
    query_pos``), with the same fp32 log arithmetic as the JAX package so
    the buckets agree exactly."""
    ret = torch.zeros_like(relative_position)
    n = relative_position
    if bidirectional:
        num_buckets //= 2
        ret = ret + (n > 0).to(ret.dtype) * num_buckets
        n = n.abs()
    else:
        n = -torch.clamp(n, max=0)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    # Larger distances: logarithmic buckets up to max_distance.
    n_f = torch.clamp(n.to(torch.float32), min=1.0)
    large = (torch.log(n_f / max_exact)
             / torch.tensor(math.log(max_distance / max_exact),
                            dtype=torch.float32)
             * (num_buckets - max_exact)).to(torch.int32)
    val_if_large = torch.clamp(max_exact + large, max=num_buckets - 1)
    return ret + torch.where(is_small, n, val_if_large.to(n.dtype))


class T5RelativePositionBias(PlanInit, nn.Module):
    """Learned bucket embedding -> (heads, Lq, Lk) additive bias. Held once
    per stack, in block 0's self-attention (HF's
    ``relative_attention_bias``)."""

    def __init__(self, num_buckets: int, max_distance: int, num_heads: int,
                 bidirectional: bool):
        super().__init__()
        self.num_buckets = num_buckets
        self.max_distance = max_distance
        self.bidirectional = bidirectional
        self.weight = nn.Parameter(torch.empty(num_buckets, num_heads))

    def forward(self, query_length: int, key_length: int,
                query_offset: int = 0) -> torch.Tensor:
        """Rows ``query_offset ..`` of ``query_length`` against every key
        (a sequence-parallel rank's rows)."""
        device = self.weight.device
        ctx = torch.arange(query_offset, query_offset + query_length,
                           device=device)[:, None]
        mem = torch.arange(key_length, device=device)[None, :]
        buckets = relative_position_bucket(
            mem - ctx, bidirectional=self.bidirectional,
            num_buckets=self.num_buckets, max_distance=self.max_distance)
        return self.weight[buckets].permute(2, 0, 1)  # (H, Lq, Lk)

    def init_plan(self) -> Plan:
        yield "weight", Init("normal", 1.0)


# ---------------------------------------------------------------------------
# Dense
# ---------------------------------------------------------------------------


class KlabDense(PlanInit, Dense):
    """Bias-free dense layer (torch layout: weight (out, in)) in the compute
    dtype, with the T5 fan-in normal init of its JAX counterpart.

    With a ``qscale`` buffer (``infer/quantize.py``) the weight is the int8
    grid ``Q`` and the per-output-channel scale multiplies the output, in
    fp32, cast back: exact for a bias-free product, ``x (Q s)^T == (x Q^T)
    s``. The int8 weight is dequantized to the compute dtype per call (the
    JAX package's int8 product is an XLA dot with a convert, no kernel)."""

    def __init__(self, in_features: int, out_features: int, init_std: float,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias=False,
                         compute_dtype=compute_dtype)
        self.init_std = init_std
        self.register_buffer("qscale", None)

    def init_plan(self) -> Plan:
        yield "weight", Init("normal", self.init_std)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = super().forward(x)
        if self.qscale is None:
            return y
        return (y.float() * self.qscale.float()).to(y.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


class T5Attention(PlanInit, nn.Module):
    """Multi-head attention without the 1/sqrt(d) scale (T5 convention).

    Modes: full-sequence self-attention, cross-attention (``kv`` given),
    and incremental decode (``cache`` given) against a fixed-shape KV cache
    with a write index: an int (every row at one position) or a (B,) int64
    tensor (every row at its own position). ``kernel_pack`` = (head bias
    (H,Q,K) fp32, key mask (B,K) int32), either may be None, routes
    full-sequence attention through the hand-written kernel. ``seq``: the
    rank's slice of a sequence-parallel stack's positions (x holds those
    rows): self-attention gathers K/V over the seq group, or, with
    ``ring``, streams them around it; the bias holds the rank's rows.
    ``batch_rows`` = (first, total): x holds rows ``first ..`` of a batch
    of ``total`` (a data rank's share of a pipelined microbatch), and the
    dropout mask is those rows' of one process.
    """

    def __init__(self, size: T5Size, has_relative_attention_bias: bool = False,
                 bidirectional: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        s = self.size = size
        # The global index of this rank's first head (tensor parallelism).
        self.head_offset = 0
        inner = s.num_heads * s.d_kv
        # Init stds follow the T5 fan-in scheme (mesh-tf init, as in HF).
        self.q = KlabDense(s.d_model, inner, (s.d_model * s.d_kv) ** -0.5,
                           dtype)
        self.k = KlabDense(s.d_model, inner, s.d_model ** -0.5, dtype)
        self.v = KlabDense(s.d_model, inner, s.d_model ** -0.5, dtype)
        self.o = KlabDense(inner, s.d_model, inner ** -0.5, dtype)
        if has_relative_attention_bias:
            self.relative_attention_bias = T5RelativePositionBias(
                s.relative_attention_num_buckets,
                s.relative_attention_max_distance, s.num_heads,
                bidirectional)

    def init_plan(self) -> Plan:
        for name in ("q", "k", "v", "o"):
            yield from sub_plan(name, getattr(self, name).init_plan())
        if hasattr(self, "relative_attention_bias"):
            yield from sub_plan("relative_attention_bias",
                                self.relative_attention_bias.init_plan())

    def _split_heads(self, t: torch.Tensor) -> torch.Tensor:
        B, L, inner = t.shape
        # The heads this rank holds: all, or num_heads / tensor.
        return t.view(B, L, inner // self.size.d_kv,
                      self.size.d_kv).transpose(1, 2)  # (B, H, L, D)

    def _merge_heads(self, t: torch.Tensor) -> torch.Tensor:
        B, H, L, D = t.shape
        return t.transpose(1, 2).reshape(B, L, H * D)

    def forward(self, x: torch.Tensor, kv: Optional[torch.Tensor] = None,
                bias: Optional[torch.Tensor] = None,
                kernel_pack: Optional[tuple] = None,
                cache: Optional[dict] = None, deterministic: bool = True,
                generator: Optional[torch.Generator] = None,
                seq=None, ring: bool = False,
                batch_rows: Optional[tuple[int, int]] = None
                ) -> torch.Tensor:
        q = self._split_heads(self.q(x))
        is_cross = kv is not None
        ring = ring and not is_cross and cache is None
        rate = 0.0 if deterministic or cache is not None else (
            self.size.dropout_rate)
        if cache is not None:
            k, v, bias = self._decode_kv(x, kv, bias, cache)
        else:
            if seq is not None and not is_cross and not ring:
                # XLA's all-gather of the sequence-sharded K/V, as one
                # exchange of both.
                k, v = seq_gather(torch.cat([self.k(x), self.v(x)], -1),
                                  seq).chunk(2, -1)
            else:
                src = kv if is_cross else x
                k, v = self.k(src), self.v(src)
            k, v = self._split_heads(k), self._split_heads(v)
            q_offset = 0 if seq is None else seq.start
            if ring:
                seed = None
                if rate > 0:
                    if generator is None:
                        raise ValueError("dropout at rate > 0 needs a "
                                         "generator")
                    seed = draw_seed(generator)
                attn = ring_self_attention(q, k, v, bias, seq, rate, seed,
                                           self.head_offset)
                return self.o(self._merge_heads(attn))
            if kernel_pack is not None:
                # The kernel drops the probabilities itself, from a seed
                # drawn from the step's generator.
                head_bias, kmask = kernel_pack
                seed = None
                if rate > 0:
                    if generator is None:
                        raise ValueError("dropout at rate > 0 needs a "
                                         "generator")
                    seed = draw_seed(generator)
                attn = t5_attention(q.contiguous(), k.contiguous(),
                                    v.contiguous(), head_bias, kmask, rate,
                                    seed, head_offset=self.head_offset,
                                    q_offset=q_offset)
                return self.o(self._merge_heads(attn))
        heads = None
        if q.shape[1] != self.size.num_heads:
            heads = (self.head_offset, self.size.num_heads)
        attn = dot_product_attention(
            q, k, v, bias=bias, dropout_rate=rate, generator=generator,
            heads=heads, rows=None if seq is None else seq.dropout_shard,
            batch=batch_rows)
        return self.o(self._merge_heads(attn))

    def _decode_kv(self, x, kv, bias, cache):
        """Keys, values and bias for one decode chunk. The cache is updated
        in place (the JAX package returns a new one)."""
        if kv is not None:
            # Cross-attention K/V depend only on the encoder output:
            # computed once at cache init, then reused each step.
            if "cached_key" not in cache:
                cache["cached_key"] = self._split_heads(self.k(kv))
                cache["cached_value"] = self._split_heads(self.v(kv))
            return cache["cached_key"], cache["cached_value"], bias
        k = self._split_heads(self.k(x))
        v = self._split_heads(self.v(x))
        B, H, T, D = k.shape
        if "cached_key" not in cache:
            max_len = bias.shape[-1] if bias is not None else T
            # One spare column past the buffer, which no query reads: a
            # per-row write past the end lands there.
            cache["cached_key"] = k.new_zeros(B, H, max_len + 1, D)
            cache["cached_value"] = v.new_zeros(B, H, max_len + 1, D)
            cache["cache_index"] = 0
        i = cache["cache_index"]
        ck, cv = cache["cached_key"], cache["cached_value"]
        max_len = ck.shape[2] - 1
        t_pos = torch.arange(T, device=x.device)
        if isinstance(i, torch.Tensor):
            # Per-row index (the engine's slots, speculative acceptance):
            # chunk token t of row b goes to position i[b] + t, in place. A
            # position past the buffer (an idle engine slot) goes to the
            # spare column, so the buffer is written exactly and only at
            # the chunk's positions.
            dst = (i[:, None] + t_pos).clamp(max=max_len)
            dst = dst[:, None, :, None].expand(B, H, T, D)
            ck.scatter_(2, dst, k)
            cv.scatter_(2, dst, v)
            q_pos = (i[:, None] + t_pos)[:, None, :, None]       # (B,1,T,1)
        else:
            ck[:, :, i:i + T] = k
            cv[:, :, i:i + T] = v
            q_pos = (i + t_pos)[None, None, :, None]
        cache["cache_index"] = i + T
        # Mask cache slots not yet written, causal per query row: the j-th
        # query of a chunk sees positions up to i + j.
        pos = torch.arange(max_len, device=x.device)[None, None, None, :]
        step_bias = torch.where(pos <= q_pos, 0.0, NEG_INF)
        bias = step_bias if bias is None else bias + step_bias
        return ck[:, :, :max_len], cv[:, :, :max_len], bias


def _t5_act(feed_forward_proj: str):
    """(activation fn, is_gated) from the HF ``feed_forward_proj`` string:
    ``gated-X`` means two input projections with X on the gate branch, and
    ``gated-gelu`` uses the tanh approximation while ``gelu`` is exact."""
    parts = feed_forward_proj.split("-")
    is_gated = parts[0] == "gated"
    name = parts[-1]
    if feed_forward_proj == "gated-gelu":
        name = "gelu_new"
    acts = {
        "relu": F.relu,
        "gelu": lambda x: F.gelu(x, approximate="none"),
        "gelu_new": lambda x: F.gelu(x, approximate="tanh"),
        "silu": F.silu,
    }
    if name not in acts:
        plain = [a for a in acts if a != "gelu_new"]
        supported = plain + [f"gated-{a}" for a in plain]
        raise ValueError(
            f"unsupported feed_forward_proj {feed_forward_proj!r}; "
            f"supported: {', '.join(supported)}")
    return acts[name], is_gated


class T5Mlp(PlanInit, nn.Module):
    """T5 feed-forward: un-gated ``wo(act(wi(x)))`` or the v1.1 gated
    ``wo(act(wi_0(x)) * wi_1(x))`` (HF's ``DenseReluDense``)."""

    def __init__(self, size: T5Size, dtype: torch.dtype = torch.float32):
        super().__init__()
        s = self.size = size
        self.act, self.gated = _t5_act(s.feed_forward_proj)
        std_in = s.d_model ** -0.5
        if self.gated:
            self.wi_0 = KlabDense(s.d_model, s.d_ff, std_in, dtype)
            self.wi_1 = KlabDense(s.d_model, s.d_ff, std_in, dtype)
        else:
            self.wi = KlabDense(s.d_model, s.d_ff, std_in, dtype)
        self.wo = KlabDense(s.d_ff, s.d_model, s.d_ff ** -0.5, dtype)
        # The global index of this rank's first d_ff column (tensor
        # parallelism).
        self.ff_offset = 0

    def init_plan(self) -> Plan:
        for name in (("wi_0", "wi_1") if self.gated else ("wi",)) + ("wo",):
            yield from sub_plan(name, getattr(self, name).init_plan())

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None,
                seq=None, batch_rows: Optional[tuple[int, int]] = None
                ) -> torch.Tensor:
        if self.gated:
            h = self.act(self.wi_0(x)) * self.wi_1(x)
        else:
            h = self.act(self.wi(x))
        rate = 0.0 if deterministic else self.size.dropout_rate
        shard = _rows(seq, batch_rows)
        if h.shape[-1] != self.size.d_ff:
            shard = (shard or []) + [(-1, self.ff_offset, self.size.d_ff)]
        return self.wo(dropout(h, rate, generator, shard))


class T5MoeMlp(PlanInit, nn.Module):
    """The JAX package's ``T5MoeMlp``: ``num_experts`` un-gated ReLU FFNs of
    the full ``d_ff`` (whatever ``feed_forward_proj`` is), a bias-free
    router in fp32 on x cast to fp32, and dense dispatch at fixed capacity
    (``ops/moe.py``). ``experts_wi`` (E, D, F) and ``experts_wo`` (E, F, D)
    are stored in fp32 and cast to x's dtype. The router is an
    ``nn.Linear`` (not a ``KlabDense``), so int8 decode leaves it and the
    expert banks unquantized, as the JAX package does. Returns ``(y,
    aux)``. After ``set_expert_group`` the banks hold the rank's experts
    only, and of each its d_ff columns under tensor parallelism
    (``tensor_shard``, which ``T5Stack.set_tensor_shard`` sets)."""

    def __init__(self, size: T5Size, num_experts: int, top_k: int = 1,
                 capacity_factor: float = 1.25):
        super().__init__()
        s = self.size = size
        self.num_experts = num_experts
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        self.router = nn.Linear(s.d_model, num_experts, bias=False)
        self.experts_wi = nn.Parameter(
            torch.empty(num_experts, s.d_model, s.d_ff))
        self.experts_wo = nn.Parameter(
            torch.empty(num_experts, s.d_ff, s.d_model))
        self.expert: Optional[ExpertGroup] = None
        # (rank, size) of the tensor group the experts' d_ff splits over.
        self.tensor_shard = (0, 1)

    def set_expert_group(self, expert: ExpertGroup) -> None:
        """Keep only ``expert``'s slice of the banks (their weights as
        they are): its experts, and of each its d_ff columns (``wi``'s dim
        2, ``wo``'s dim 1); run that slice from now on."""
        if (expert.tensor_rank, expert.tensor) != self.tensor_shard:
            raise ValueError(f"an expert group at tensor rank "
                             f"{expert.tensor_rank} of {expert.tensor} for "
                             f"banks of tensor shard {self.tensor_shard}")
        mine = expert.experts(self.num_experts)
        cols = expert.columns(self.size.d_ff)
        for name, dim in (("experts_wi", 2), ("experts_wo", 1)):
            bank = getattr(self, name)
            part = bank.detach()[mine].narrow(dim, cols.start,
                                              cols.stop - cols.start)
            setattr(self, name, nn.Parameter(
                part.clone(), requires_grad=bank.requires_grad))
        self.expert = expert

    def init_plan(self) -> Plan:
        yield "router.weight", Init("normal", self.size.d_model ** -0.5)
        yield "experts_wi", Init("normal", self.size.d_model ** -0.5)
        yield "experts_wo", Init("normal", self.size.d_ff ** -0.5)

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None,
                mask: Optional[torch.Tensor] = None, seq=None
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """``x`` (G, S, D) and the groups' token ``mask``; with ``seq`` (a
        ``SeqSlice``) x holds its positions of groups of ``seq.length``,
        ``mask`` their whole (G, seq.length) mask, and the capacity is the
        full length's (``topk_routing``)."""
        # The router in fp32: routing must not flip with the compute dtype.
        logits = F.linear(x.float(), self.router.weight.float())
        cap = moe_capacity(x.shape[1] if seq is None else seq.length,
                           self.num_experts, self.top_k, self.capacity_factor)
        combine, aux = topk_routing(logits, self.top_k, cap, mask=mask,
                                    seq=seq)
        rate = 0.0 if deterministic else self.size.dropout_rate
        y = moe_ffn(x, combine, self.experts_wi, self.experts_wo, rate,
                    generator, self.expert)
        return y.to(x.dtype), aux


class T5Block(PlanInit, nn.Module):
    """Pre-norm residual block: self-attn [-> cross-attn] -> MLP, laid out
    as HF's ``layer`` list so parameter names match. With ``moe_experts >
    0`` the MLP is a ``T5MoeMlp`` (named ``mlp``, beside the layer norm
    where HF has ``DenseReluDense``) and the block returns ``(x, aux)``."""

    def __init__(self, size: T5Size, has_cross_attention: bool,
                 has_relative_attention_bias: bool,
                 dtype: torch.dtype = torch.float32, moe_experts: int = 0,
                 moe_top_k: int = 1, moe_capacity_factor: float = 1.25):
        super().__init__()
        s = self.size = size
        self.has_cross_attention = has_cross_attention
        self.moe = moe_experts > 0
        eps = s.layer_norm_epsilon
        layers = [nn.ModuleDict({
            "layer_norm": RMSNorm(s.d_model, eps),
            "SelfAttention": T5Attention(
                s, has_relative_attention_bias,
                bidirectional=not has_cross_attention, dtype=dtype)})]
        if has_cross_attention:
            layers.append(nn.ModuleDict({
                "layer_norm": RMSNorm(s.d_model, eps),
                "EncDecAttention": T5Attention(s, dtype=dtype)}))
        if self.moe:
            layers.append(nn.ModuleDict({
                "layer_norm": RMSNorm(s.d_model, eps),
                "mlp": T5MoeMlp(s, moe_experts, moe_top_k,
                                moe_capacity_factor)}))
        else:
            layers.append(nn.ModuleDict({
                "layer_norm": RMSNorm(s.d_model, eps),
                "DenseReluDense": T5Mlp(s, dtype)}))
        self.layer = nn.ModuleList(layers)

    def init_plan(self) -> Plan:
        for i, sub in enumerate(self.layer):
            for key, m in sub.items():
                yield from sub_plan(f"layer.{i}.{key}", m.init_plan())

    def forward(self, x, self_bias, enc_out, cross_bias, self_pack=None,
                cross_pack=None, cache: Optional[dict] = None,
                moe_mask: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None,
                seq=None, ring: bool = False,
                batch_rows: Optional[tuple[int, int]] = None):
        rate = 0.0 if deterministic else self.size.dropout_rate
        rows = _rows(seq, batch_rows)
        sa = self.layer[0]
        h = sa["SelfAttention"](sa["layer_norm"](x), bias=self_bias,
                                kernel_pack=self_pack,
                                cache=None if cache is None else cache["self"],
                                deterministic=deterministic,
                                generator=generator, seq=seq, ring=ring,
                                batch_rows=batch_rows)
        x = x + dropout(h, rate, generator, rows)
        if self.has_cross_attention:
            ca = self.layer[1]
            h = ca["EncDecAttention"](
                ca["layer_norm"](x), kv=enc_out, bias=cross_bias,
                kernel_pack=cross_pack,
                cache=None if cache is None else cache["cross"],
                deterministic=deterministic, generator=generator, seq=seq,
                batch_rows=batch_rows)
            x = x + dropout(h, rate, generator, rows)
        ff = self.layer[-1]
        if self.moe:
            h, aux = ff["mlp"](ff["layer_norm"](x), deterministic, generator,
                               mask=moe_mask, seq=seq)
            return x + dropout(h, rate, generator, rows), aux
        h = ff["DenseReluDense"](ff["layer_norm"](x), deterministic,
                                 generator, seq, batch_rows)
        return x + dropout(h, rate, generator, rows)


def _rows(seq, batch_rows: Optional[tuple[int, int]] = None
          ) -> Optional[list]:
    """``dropout``'s shards of a (B, L, ...) activation under a seq slice
    (the rank's positions of a mask drawn at the full length) and a share
    of the batch (``batch_rows`` = (first, total): the rank's rows of a mask
    drawn at all ``total``); None without either."""
    shards = ([] if batch_rows is None else [(0, *batch_rows)]) + (
        [] if seq is None else [(1, *seq.dropout_shard)])
    return shards or None


def _mask_to_bias(mask: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """(B, K) key mask -> (B, 1, 1, K) additive fp32 bias."""
    if mask is None:
        return None
    return torch.where(mask[:, None, None, :] > 0, 0.0, NEG_INF)


def _assemble_dense_biases(head_bias, kmask, enc_out, cross_kmask):
    """Reference-path logit biases from the decomposed attention inputs:
    the shared (H, Q, K) head bias broadcast over batch (a (B, H, Q, K) one
    is already per row: decode at per-row positions) plus the key-mask
    bias, and the cross-attention key-mask bias."""
    self_bias = None
    if head_bias is not None:
        self_bias = head_bias if head_bias.dim() == 4 else head_bias[None]
    mask_bias = _mask_to_bias(kmask)
    if mask_bias is not None:
        self_bias = mask_bias if self_bias is None else self_bias + mask_bias
    cross_bias = None
    if enc_out is not None:
        cross_bias = _mask_to_bias(cross_kmask)
    return self_bias, cross_bias


# The aten products that 'dots_saveable' keeps (jax.checkpoint_policies.
# dots_saveable keeps every dot_general's output): F.linear and torch.matmul
# reach these.
_DOTS = frozenset((torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                   torch.ops.aten.addmm.default,
                   torch.ops.aten.baddbmm.default))


def _save_dots(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_block(blk: nn.Module, remat: str, x: torch.Tensor,
                 generator: Optional[torch.Generator], **kwargs
                 ) -> torch.Tensor:
    """``blk(x, **kwargs)`` under activation checkpointing ('full': keep
    only the block's input; 'dots_saveable': keep the matrix products'
    outputs too). The forward records ``generator``'s state; the recompute
    sets it back, runs, and restores the state it found."""
    state = None if generator is None else generator.get_state()
    calls = []

    def run(x):
        if calls and state is not None:  # the backward's recompute
            found = generator.get_state()
            generator.set_state(state)
            try:
                return blk(x, generator=generator, **kwargs)
            finally:
                generator.set_state(found)
        calls.append(1)
        return blk(x, generator=generator, **kwargs)

    context = ckpt.noop_context_fn
    if remat == "dots_saveable":
        context = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _save_dots)
    return ckpt.checkpoint(run, x, use_reentrant=False,
                           preserve_rng_state=False, context_fn=context)


class T5Stack(PlanInit, nn.Module):
    """Encoder or decoder stack (embedding handled by the caller).

    Callers pass the decomposed attention inputs: a shared per-head bias
    ``head_bias`` (H, Q, K) and raw key masks ``kmask``/``cross_kmask``
    (B, K). The reference path sums them into dense logit biases; the kernel
    path (``use_pallas``) hands them to the kernel unchanged. ``remat``
    checkpoints each block when autograd records (see ``_remat_block``).
    With ``moe_experts > 0`` the forward returns ``(hidden, the sum of the
    blocks' balance losses)``; with ``pipeline_stages > 1`` a full-sequence
    forward runs the GPipe schedule (``_pipelined``). With a seq group
    (``set_seq_group``) a full-sequence forward whose length divides by
    it runs the rank's positions: the caller passes the rank's rows of the
    head bias (``position_bias``), and the output is the rank's rows, or
    the whole sequence with ``gather_output`` (an encoder's). A pipelined
    stack on one of several data ranks (``set_batch_share``) draws its
    dropout masks as one process draws them for the whole batch, and keeps
    its rows of them.
    """

    def __init__(self, size: T5Size, num_layers: int, is_decoder: bool,
                 use_pallas: bool = False, dtype: torch.dtype = torch.float32,
                 remat: str = "", pipeline_stages: int = 1,
                 pipeline_microbatches: int = 0, moe_experts: int = 0,
                 moe_top_k: int = 1, moe_capacity_factor: float = 1.25,
                 gather_output: bool = False):
        super().__init__()
        self.size = size
        self.use_pallas = use_pallas
        self.gather_output = gather_output
        # Sequence parallelism (set_seq_group): the seq group, the mesh
        # (the ring's gate reads it) and --seq_attention ring.
        self.seq_group = None
        self.mesh = None
        self.ring_attention = False
        self.remat = remat
        self.pipeline_stages = pipeline_stages
        self.pipeline_microbatches = pipeline_microbatches
        self.moe = moe_experts > 0
        # (rank, size) of the tensor group this stack's heads split over.
        self.tensor_shard = (0, 1)
        # The pipe group whose stage this rank runs (split_stages).
        self.pipe: Optional[PipeGroup] = None
        # (rank, size) of the data ranks whose rows make up the batch of a
        # pipelined forward (set_batch_share).
        self.batch_share = (0, 1)
        # The group of the ranks that hold the other rows, over which the
        # balance loss is one mean (set_aux_group).
        self.aux_group = None
        self.block = nn.ModuleList(
            T5Block(size, is_decoder, has_relative_attention_bias=(i == 0),
                    dtype=dtype, moe_experts=moe_experts,
                    moe_top_k=moe_top_k,
                    moe_capacity_factor=moe_capacity_factor)
            for i in range(num_layers))
        self.final_layer_norm = RMSNorm(size.d_model, size.layer_norm_epsilon)

    @property
    def relative_attention_bias(self) -> T5RelativePositionBias:
        return self.block[0].layer[0]["SelfAttention"].relative_attention_bias

    def init_plan(self) -> Plan:
        for i, blk in enumerate(self.block):
            yield from sub_plan(f"block.{i}", blk.init_plan())
        yield from sub_plan("final_layer_norm",
                            self.final_layer_norm.init_plan())

    def set_tensor_shard(self, rank: int, size: int) -> None:
        """Run heads ``rank * H / size ..`` and the same share of d_ff
        columns: the layout that ``parallel/partitioning.py`` gives this
        stack's weights over a tensor group of ``size``. MoE blocks learn
        the shard here; their banks are cut by ``split_experts``."""
        s = self.size
        if s.num_heads % size or s.d_ff % size:
            raise ValueError(f"num_heads={s.num_heads} and d_ff={s.d_ff} "
                             f"must divide by the tensor axis {size}")
        self.tensor_shard = (rank, size)
        for m in self.modules():
            if isinstance(m, T5Attention):
                m.head_offset = rank * s.num_heads // size
            elif isinstance(m, T5Mlp):
                m.ff_offset = rank * s.d_ff // size
            elif isinstance(m, T5MoeMlp):
                m.tensor_shard = (rank, size)

    def set_pipe_group(self, pipe: PipeGroup) -> None:
        """Hold and run only stage ``pipe.rank``'s blocks: the others'
        places in ``block`` become empty, but block 0's relative-position
        table, which every stage reads (the JAX package keeps it outside
        its stacks), stays under its name."""
        S, L = self.pipeline_stages, len(self.block)
        if pipe.size != S or L % S:
            raise ValueError(f"a pipe group of {pipe.size} ranks for "
                             f"pipeline_stages={S} and {L} blocks")
        table = self.relative_attention_bias
        per = L // S
        for i in range(L):
            if i // per != pipe.rank:
                self.block[i] = _TableOnly(table) if i == 0 else _Elsewhere()
        self.pipe = pipe

    def set_batch_share(self, rank: int, size: int) -> None:
        """This rank holds rows ``rank * B ..`` of a batch of ``size * B``
        (the data x fsdp ranks' equal chunks, ``Mesh.dp_rank``): a
        pipelined forward then draws each dropout mask at the whole batch's
        rows, keyed on one process's microbatches, and keeps its own rows,
        as the JAX package's rows on ``(data, fsdp)`` give them."""
        self.batch_share = (rank, size)

    def set_seq_group(self, seq_group, mesh, ring: bool = False) -> None:
        """Split full-sequence forwards over ``seq_group`` (a
        ``parallel.partitioning.SeqGroup``) of ``mesh``; ``ring``: stream
        self-attention's K/V around it (``--seq_attention ring``) where
        ``ring_applicable`` holds and the T5 kernel is off, as the JAX
        package's gate reads."""
        self.seq_group, self.mesh, self.ring_attention = seq_group, mesh, ring

    def seq_slice(self, length: int):
        """This rank's ``SeqSlice`` of a full sequence of ``length``, or
        None (no seq group, or a length that does not divide by it)."""
        if self.seq_group is None:
            return None
        return self.seq_group.split(length)

    def position_bias(self, length: int, causal: bool = False
                      ) -> torch.Tensor:
        """The (H, rows, length) relative-position bias (plus the causal
        mask) of this rank's query rows of a full sequence: all of them
        without a seq slice."""
        seq = self.seq_slice(length)
        start, rows = (0, length) if seq is None else (seq.start, seq.rows)
        bias = self.relative_attention_bias(rows, length, start)
        if causal:
            bias = bias + causal_bias(length, bias.device, start, rows)
        return bias

    def _local_heads(self, head_bias: Optional[torch.Tensor]
                     ) -> Optional[torch.Tensor]:
        """This rank's rows of a (H, Q, K) or (B, H, Q, K) head bias."""
        rank, size = self.tensor_shard
        if head_bias is None or size == 1:
            return head_bias
        per = self.size.num_heads // size
        return head_bias.narrow(head_bias.dim() - 3, rank * per, per)

    def forward(self, inputs_embeds: torch.Tensor,
                head_bias: Optional[torch.Tensor] = None,
                kmask: Optional[torch.Tensor] = None,
                enc_out: Optional[torch.Tensor] = None,
                cross_kmask: Optional[torch.Tensor] = None,
                cache: Optional[Cache] = None, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        deterministic = deterministic or cache is not None
        rate = 0.0 if deterministic else self.size.dropout_rate
        seq = None if cache is not None else self.seq_slice(
            inputs_embeds.shape[1])
        # Every mask is drawn at the full length: a seq rank keeps its rows;
        # and under a pipeline at the whole batch: a data rank its rows.
        pipelined = self.pipeline_stages > 1 and cache is None
        batch = self._batch_rows(inputs_embeds.shape[0]) if pipelined else None
        x = seq_shard(dropout(inputs_embeds, rate, generator, _rows(
            None, batch)), seq)
        head_bias = self._local_heads(head_bias)
        if self.pipeline_stages > 1:
            if cache is not None:
                raise ValueError(
                    "incremental decode with a pipelined stack: run a "
                    "pipeline_stages=1 model (the same state dict)")
            if self.moe:
                raise ValueError(
                    "moe_experts > 0 with pipeline_stages > 1 is not "
                    "supported (config validation should have caught this)")
            x = self._pipelined(x, head_bias, kmask, enc_out, cross_kmask,
                                deterministic, generator)
            return dropout(self.final_layer_norm(x), rate, generator,
                           _rows(None, batch))
        self_bias = cross_bias = self_pack = cross_pack = None
        if self.use_pallas and cache is None:
            self_pack = (_kernel_bias(head_bias), _kernel_mask(kmask))
            if enc_out is not None:
                cross_pack = (None, _kernel_mask(cross_kmask))
        else:
            self_bias, cross_bias = _assemble_dense_biases(
                head_bias, kmask, enc_out, cross_kmask)
        kw = dict(self_bias=self_bias, enc_out=enc_out, cross_bias=cross_bias,
                  self_pack=self_pack, cross_pack=cross_pack,
                  deterministic=deterministic)
        if seq is not None:
            L = inputs_embeds.shape[1]
            kw.update(seq=seq, ring=(
                self.ring_attention and self_pack is None and ring_applicable(
                    L, L, self.mesh, batch=x.shape[0] * self.mesh.dp_size,
                    num_heads=self.size.num_heads)))
        if self.moe:
            # The key mask is also the routing mask: pads route nowhere
            # (whole under seq: each layer routes the rank's positions).
            kw["moe_mask"] = kmask
        x, aux = self._run_blocks(self.block, x, kw, generator, cache)
        if self.moe and cache is None:
            if (seq is None and self.seq_group is not None
                    and self.seq_group.rank):
                # Whole on every seq rank: seq rank 0 counts it.
                aux = aux * 0.0
            aux = balance_share(aux, kmask, x.shape[0], self.aux_group)
        x = dropout(self.final_layer_norm(x), rate, generator, _rows(seq))
        if self.gather_output:
            x = seq_gather(x, seq)
        return (x, aux) if self.moe else x

    def _run_blocks(self, blocks, x, kw: dict, generator, cache=None):
        """``blocks`` in order on ``x``: (x, the sum of their balance
        losses, or None for dense blocks)."""
        remat = self.remat if torch.is_grad_enabled() and cache is None else ""
        aux = None
        for i, blk in enumerate(blocks):
            if remat:
                out = _remat_block(blk, remat, x, generator, **kw)
            else:
                out = blk(x, cache=None if cache is None else cache[i],
                          generator=generator, **kw)
            if self.moe:
                x, a = out
                aux = a if aux is None else aux + a
            else:
                x = out
        return x, aux

    def _batch_rows(self, rows: int) -> Optional[tuple[int, int]]:
        """(first, total): this rank's ``rows`` within the whole batch of the
        data ranks (``set_batch_share``); None on one data rank."""
        rank, size = self.batch_share
        return None if size == 1 else (rank * rows, size * rows)

    def _microbatch_place(self, B: int, M: int):
        """m -> where this rank's microbatch m (rows ``m B / M ..`` of its
        B) lies in one process's schedule of the whole batch: (the index of
        the microbatch that holds those rows, their ``batch_rows`` in it,
        or None on one data rank). Each data rank's microbatch is a slice
        of one of one process's: their rows are consecutive."""
        rank, size = self.batch_share
        rows, whole = B // M, B * size // M

        def place(m: int):
            if size == 1:
                return m, None
            first = rank * B + m * rows
            return first // whole, (first % whole, whole)

        return place

    def _stage(self, s: int, mb: dict, head_bias, deterministic: bool,
               generator, batch_rows=None) -> torch.Tensor:
        """Stage ``s`` of the pipeline (its ``num_layers / S`` consecutive
        blocks) on one microbatch ``mb`` (its activations ``x``, key masks
        and encoder context), which holds ``batch_rows`` of one process's
        microbatch (None: all of it). The dense logit biases are assembled
        here from the shared head bias and the microbatch's masks, as the
        JAX package's ``_StageBlocks`` does, so a microbatch carries only
        its (rows, K) masks."""
        per = len(self.block) // self.pipeline_stages
        self_bias, cross_bias = _assemble_dense_biases(
            head_bias, mb.get("kmask"), mb.get("enc_out"),
            mb.get("cross_kmask"))
        kw = dict(self_bias=self_bias, enc_out=mb.get("enc_out"),
                  cross_bias=cross_bias, deterministic=deterministic,
                  batch_rows=batch_rows)
        x, _ = self._run_blocks(self.block[s * per:(s + 1) * per], mb["x"],
                                kw, generator)
        return x

    def _pipelined(self, x, head_bias, kmask, enc_out, cross_kmask,
                   deterministic: bool, generator) -> torch.Tensor:
        """The JAX package's GPipe schedule (``_PipelineTicks``): M
        microbatches (``pipeline_microbatches`` or S) of B / M rows through
        S stages in M + S - 1 ticks. At tick t stage s takes what stage
        s - 1 gave at tick t - 1 (stage 0 takes microbatch t) and runs
        microbatch t - s where 0 <= t - s < M. Each microbatch carries its
        activations, key masks and encoder context; the head bias is shared.
        The last stage's outputs are put back in batch order. Stage s on
        microbatch m draws its dropout from ``_stage_generators``' (s, m).

        The JAX package also runs the padding lanes (t - s outside [0, M),
        fed ``t % M`` and masks seeded with ones) because its stages are one
        vmapped SPMD program that must stay finite everywhere; their outputs
        are never emitted. Here a stage that holds no microbatch at a tick
        does nothing. Under a pipe group (``set_pipe_group``) this rank runs
        its stage alone, in the same microbatch order, and the shift
        between stages goes to the next rank (``pipe_stages``). On one of
        several data ranks (``set_batch_share``) the microbatches are of
        the rank's rows, and each draws its dropout as the part of one
        process's microbatch that it is (``_microbatch_place``)."""
        S = self.pipeline_stages
        if len(self.block) % S:
            raise ValueError(f"num_layers={len(self.block)} not divisible "
                             f"by pipeline_stages={S}")
        if self.use_pallas:
            raise ValueError("pipeline_stages > 1 is incompatible with "
                             "the T5 attention kernel (use_pallas)")
        B = x.shape[0]
        M = self.pipeline_microbatches or S
        if B % M:
            raise ValueError(f"batch={B} not divisible by "
                             f"pipeline_microbatches={M}")
        rate = 0.0 if deterministic else self.size.dropout_rate
        gens = _stage_generators(generator if rate > 0 else None)
        place = self._microbatch_place(B, M)
        if self.pipe is not None:
            s = self.pipe.rank
            per = len(self.block) // S

            def stage_fn(m, xm, hb, eom, km, ckm):
                mb = {k: v for k, v in (("x", xm), ("kmask", km),
                                        ("enc_out", eom),
                                        ("cross_kmask", ckm))
                      if v is not None}
                g, batch_rows = place(m)
                return self._stage(s, mb, hb, deterministic, gens(s, g),
                                   batch_rows)

            return pipe_stages(stage_fn, list(self.block[s * per:
                                                         (s + 1) * per]),
                               self.pipe, M, x, head_bias, enc_out, kmask,
                               cross_kmask)
        rows = B // M
        travel = {k: v for k, v in (("x", x), ("kmask", kmask),
                                    ("enc_out", enc_out),
                                    ("cross_kmask", cross_kmask))
                  if v is not None}
        microbatches = [dict({k: v[m * rows:(m + 1) * rows]
                              for k, v in travel.items()}, m=m)
                        for m in range(M)]

        def run(s: int, mb: dict) -> torch.Tensor:
            g, batch_rows = place(mb["m"])
            return self._stage(s, mb, head_bias, deterministic, gens(s, g),
                               batch_rows)

        held: list = [None] * S  # what each stage gave at the last tick
        out = []
        for t in range(M + S - 1):
            # The shift: stage 0 takes microbatch t, stage s what s - 1 gave.
            inputs = [microbatches[t] if t < M else None] + held[:-1]
            held = [None if mb is None else dict(mb, x=run(s, mb))
                    for s, mb in enumerate(inputs)]
            if held[-1] is not None:
                out.append(held[-1]["x"])
        return torch.cat(out)


class _Elsewhere(nn.Module):
    """The place in ``T5Stack.block`` of a block another pipe rank holds."""


class _TableOnly(nn.Module):
    """Block 0's place on a pipe rank that does not hold block 0: its
    relative-position table alone, under the table's name
    (``layer.0.SelfAttention.relative_attention_bias``)."""

    def __init__(self, table: nn.Module):
        super().__init__()
        holder = nn.Module()
        holder.relative_attention_bias = table
        self.layer = nn.ModuleList([nn.ModuleDict({"SelfAttention": holder})])


def _stage_generators(generator: Optional[torch.Generator]):
    """(stage, microbatch) -> the generator that stage's blocks draw their
    dropout from on that microbatch (None without ``generator``): seeded
    from a hash of ``generator``'s state (on the host: no device sync) and
    the pair, so that the masks do not depend on the order in which the
    stages run, on one rank or on several. ``generator`` then moves on by
    one draw, as every rank's does."""
    if generator is None:
        return lambda s, m: None
    key = hashlib.blake2b(generator.get_state().numpy().tobytes(),
                          digest_size=16).digest()
    torch.rand((1,), generator=generator, device=generator.device)

    def gen(s: int, m: int) -> torch.Generator:
        seed = int.from_bytes(hashlib.blake2b(
            key + f"{s},{m}".encode(), digest_size=8).digest(), "little")
        return torch.Generator(device=generator.device).manual_seed(
            seed & (2 ** 63 - 1))

    return gen


# A dense block's MLP weight in a T5ForConditionalGeneration state dict.
_DENSE_MLP = re.compile(
    r"^((?:encoder|decoder)\.block\.\d+\.layer\.\d+\.)"
    r"DenseReluDense\.(wi|wo|wi_0|wi_1)\.weight$")


def upcycle_t5_params(dense: dict, fresh_moe: dict) -> dict:
    """Sparse upcycling (Komatsuzaki et al. 2023), the JAX package's
    ``upcycle_t5_params`` on the port's ``T5ForConditionalGeneration``
    state dicts: every expert starts as a copy of its block's dense ``wi``
    / ``wo`` (in fp32), the router keeps ``fresh_moe``'s init (a fresh MoE
    model of the same geometry), and every other tensor is ``dense``'s, the
    same tensor object. Optimizer state is not upcycled: the paper's
    procedure, ``init_checkpoint``, starts a fresh optimizer."""
    out = {}
    for key, value in dense.items():
        m = _DENSE_MLP.match(key)
        if m is None:
            out[key] = value
            continue
        prefix, name = m.groups()
        target = f"{prefix}mlp.experts_{name}"
        if target not in fresh_moe:
            raise ValueError(
                "upcycle_t5_params needs a dense source (mlp/wi) and an "
                "MoE target (mlp/experts_wi)")
        # torch's (out, in) weight is the expert bank's (in, out) slice.
        w = value.float().t().contiguous()
        out[target] = w.expand(fresh_moe[target].shape[0], *w.shape).clone()
        out[f"{prefix}mlp.router.weight"] = fresh_moe[
            f"{prefix}mlp.router.weight"]
    return out


def _kernel_bias(bias: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if bias is None else bias.float().contiguous()


def _kernel_mask(mask: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if mask is None else mask.to(torch.int32).contiguous()


# ---------------------------------------------------------------------------
# Top-level models
# ---------------------------------------------------------------------------


class T5Encoder(PlanInit, nn.Module):
    """T5EncoderModel equivalent. Accepts token ids or ``inputs_embeds``.

    ``dtype``: the compute dtype. ``device``: None means the card (see
    ``utils.device``)."""

    def __init__(self, size: T5Size, use_pallas: bool = False,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        with torch.device(resolve_device(device)):
            self.size = size
            self.dtype = dtype
            self.shared = nn.Embedding(size.vocab_size, size.d_model)
            self.encoder = T5Stack(size, size.num_layers, is_decoder=False,
                                   use_pallas=use_pallas, dtype=dtype,
                                   gather_output=True)

    def init_plan(self) -> Plan:
        yield "shared.weight", Init("normal", 1.0)
        yield from sub_plan("encoder", self.encoder.init_plan())

    def forward(self, input_ids: Optional[torch.Tensor] = None,
                inputs_embeds: Optional[torch.Tensor] = None,
                attention_mask: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if inputs_embeds is None:
            inputs_embeds = self.shared(input_ids.long()).to(self.dtype)
        L = inputs_embeds.shape[1]
        return self.encoder(inputs_embeds, head_bias=self.encoder
                            .position_bias(L), kmask=attention_mask,
                            deterministic=deterministic, generator=generator)


def new_cache(num_layers: int) -> Cache:
    """An empty decode cache; the first ``decode_step`` fills it."""
    return [{"self": {}, "cross": {}} for _ in range(num_layers)]


@dataclasses.dataclass
class Seq2SeqOutput:
    loss: Optional[torch.Tensor]
    logits: torch.Tensor
    encoder_last_hidden_state: torch.Tensor
    # MoE only: both stacks' summed balance losses, raw (``loss`` already
    # holds them times moe_aux_loss_weight).
    aux_loss: Optional[torch.Tensor] = None


def causal_bias(length: int, device=None, query_offset: int = 0,
                query_length: Optional[int] = None) -> torch.Tensor:
    """(Q, L) fp32: 0 where the key is at or before the query, else -1e9;
    query rows ``query_offset ..`` of ``query_length`` (all L by
    default)."""
    idx = torch.arange(length, device=device)
    q = torch.arange(query_offset, query_offset + (
        length if query_length is None else query_length), device=device)
    return torch.where(q[:, None] >= idx[None, :], 0.0, NEG_INF)


def shift_right(labels: torch.Tensor, decoder_start_token_id: int,
                pad_token_id: int) -> torch.Tensor:
    """HF ``_shift_right``: prepend the start token, drop the last, map -100
    to the pad id."""
    start = torch.full(labels.shape[:-1] + (1,), decoder_start_token_id,
                       dtype=labels.dtype, device=labels.device)
    shifted = torch.cat([start, labels[..., :-1]], dim=-1)
    return torch.where(shifted == -100, pad_token_id, shifted)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       weights: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Token-level cross entropy in fp32, mean over the weighted positions
    (every position when ``weights`` is None)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    label_logit = torch.gather(logits, -1, labels.long().clamp(min=0)[..., None]
                               )[..., 0]
    nll = logz - label_logit
    weights = (torch.ones_like(nll) if weights is None
               else weights.to(torch.float32))
    return (nll * weights).sum() / torch.clamp(weights.sum(), min=1.0)


class T5ForConditionalGeneration(PlanInit, nn.Module):
    """Full encoder-decoder with the tied (or untied) LM head.

    ``dtype``: the compute dtype. ``remat``: '', 'full' or 'dots_saveable'
    (see ``_remat_block``). ``pipeline_stages`` / ``pipeline_microbatches``:
    the GPipe schedule of both stacks' full-sequence forwards. ``moe_*``:
    the mixture of experts in both stacks' MLPs (see the module doc).
    ``device``: None means the card (see ``utils.device``)."""

    def __init__(self, size: T5Size, use_pallas: bool = False,
                 dtype: torch.dtype = torch.float32, remat: str = "",
                 device=None, pipeline_stages: int = 1,
                 pipeline_microbatches: int = 0, moe_experts: int = 0,
                 moe_top_k: int = 1, moe_capacity_factor: float = 1.25,
                 moe_aux_loss_weight: float = 0.01):
        super().__init__()
        with torch.device(resolve_device(device)):
            s = self.size = size
            self.dtype = dtype
            self.moe_kwargs = dict(moe_experts=moe_experts,
                                   moe_top_k=moe_top_k,
                                   moe_capacity_factor=moe_capacity_factor)
            self.moe_aux_loss_weight = moe_aux_loss_weight
            stack = dict(use_pallas=use_pallas, dtype=dtype, remat=remat,
                         pipeline_stages=pipeline_stages,
                         pipeline_microbatches=pipeline_microbatches,
                         **self.moe_kwargs)
            self.shared = nn.Embedding(s.vocab_size, s.d_model)
            self.encoder = T5Stack(s, s.num_layers, is_decoder=False,
                                   gather_output=True, **stack)
            self.decoder = T5Stack(s, s.num_decoder_layers, is_decoder=True,
                                   **stack)
            if not s.tie_word_embeddings:
                self.lm_head = KlabDense(s.d_model, s.vocab_size,
                                         s.d_model ** -0.5, dtype)
            # The int8 tied head (infer/quantize.py); None otherwise.
            self.register_buffer("head_q", None)
            self.register_buffer("head_scale", None)

    def init_plan(self) -> Plan:
        yield "shared.weight", Init("normal", 1.0)
        yield from sub_plan("encoder", self.encoder.init_plan())
        yield from sub_plan("decoder", self.decoder.init_plan())
        if not self.size.tie_word_embeddings:
            yield from sub_plan("lm_head", self.lm_head.init_plan())

    def split_stages(self, pipe: PipeGroup) -> None:
        """Both stacks hold and run only stage ``pipe.rank`` of their
        GPipe schedules (a ``pipe`` mesh axis; ``T5Stack.
        set_pipe_group``)."""
        for stack in (self.encoder, self.decoder):
            stack.set_pipe_group(pipe)

    def split_experts(self, expert: ExpertGroup) -> None:
        """Every MoE layer holds and runs only ``expert``'s slice: its
        experts (an ``expert`` mesh axis) and, after ``T5Stack.
        set_tensor_shard``, their d_ff columns (``T5MoeMlp.
        set_expert_group``)."""
        for m in self.modules():
            if isinstance(m, T5MoeMlp):
                m.set_expert_group(expert)

    def set_batch_share(self, rank: int, size: int) -> None:
        """Both stacks hold data rank ``rank``'s rows of ``size`` ranks'
        (``T5Stack.set_batch_share``)."""
        for stack in (self.encoder, self.decoder):
            stack.set_batch_share(rank, size)

    def set_aux_group(self, group) -> None:
        """Take both stacks' balance losses as this rank's share of one
        mean over the groups of every rank of ``group`` (the ranks that
        hold the other rows; None: this rank's alone)."""
        for stack in (self.encoder, self.decoder):
            stack.aux_group = group

    def _embed(self, ids: torch.Tensor) -> torch.Tensor:
        return self.shared(ids.long()).to(self.dtype)

    def _split_aux(self, stack_out):
        """MoE stacks return (hidden, aux); dense stacks return hidden."""
        return stack_out if self.encoder.moe else (stack_out, None)

    def encode(self, input_ids=None, inputs_embeds=None,
               attention_mask=None, deterministic: bool = True,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self._encode_with_aux(input_ids, inputs_embeds,
                                     attention_mask, deterministic,
                                     generator)[0]

    def _encode_with_aux(self, input_ids, inputs_embeds, attention_mask,
                         deterministic, generator):
        if inputs_embeds is None:
            inputs_embeds = self._embed(input_ids)
        L = inputs_embeds.shape[1]
        return self._split_aux(self.encoder(
            inputs_embeds, head_bias=self.encoder.position_bias(L),
            kmask=attention_mask,
            deterministic=deterministic, generator=generator))

    def _lm_logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """Logits in the compute dtype (flax ``Embed.attend`` for the tied
        head). With ``head_q`` / ``head_scale`` buffers (the int8 tied head
        of ``infer/quantize.py``) the head reads the int8 copy and the
        per-vocab-row scale multiplies the logits in fp32."""
        s = self.size
        if s.tie_word_embeddings:
            hidden = (hidden * (s.d_model ** -0.5)).to(self.dtype)
            if self.head_q is not None:
                logits = F.linear(hidden, self.head_q.to(self.dtype))
                return (logits.float() * self.head_scale.float()).to(
                    logits.dtype)
            # Under tensor parallelism the embedding is split over the
            # vocab, and so are the logits until they are gathered for the
            # loss (``tied_logits``).
            return tied_logits(hidden, self.shared.weight.to(self.dtype))
        return gather_columns(self.lm_head(hidden), self.lm_head.weight)

    def decode_train(self, decoder_input_ids: torch.Tensor,
                     encoder_hidden: torch.Tensor,
                     encoder_attention_mask: Optional[torch.Tensor] = None,
                     decoder_attention_mask: Optional[torch.Tensor] = None,
                     deterministic: bool = True,
                     generator: Optional[torch.Generator] = None
                     ) -> torch.Tensor:
        """Teacher-forced decoder over the whole target: (B, L) ids ->
        (B, L, vocab) logits (a seq rank's rows of them under sequence
        parallelism). The self-attention bias is the relative-position bias
        plus the causal mask."""
        return self._decode_train_with_aux(
            decoder_input_ids, encoder_hidden, encoder_attention_mask,
            decoder_attention_mask, deterministic, generator)[0]

    def _decode_train_with_aux(self, decoder_input_ids, encoder_hidden,
                               encoder_attention_mask, decoder_attention_mask,
                               deterministic, generator):
        L = decoder_input_ids.shape[1]
        head_bias = self.decoder.position_bias(L, causal=True)
        hidden, aux = self._split_aux(self.decoder(
            self._embed(decoder_input_ids), head_bias=head_bias,
            kmask=decoder_attention_mask, enc_out=encoder_hidden,
            cross_kmask=encoder_attention_mask, deterministic=deterministic,
            generator=generator))
        return self._lm_logits(hidden), aux

    def decode_step(self, decoder_input_token: torch.Tensor, step,
                    encoder_hidden: torch.Tensor, max_decode_len: int,
                    encoder_attention_mask: Optional[torch.Tensor] = None,
                    cache: Optional[Cache] = None
                    ) -> tuple[torch.Tensor, Cache]:
        """One incremental decode step: ``decoder_input_token`` (B, T)
        starts at position ``step``: a Python int (all rows at the same
        position, the generate loops) or a (B,) int64 tensor (every row at
        its own position: the engine and speculative decoding, whose caches
        carry per-row ``cache_index`` tensors). ``cache=None`` starts a new
        cache. Returns ((B, T, vocab) logits, the cache, updated in place).

        The bias rows start at ``step`` clamped to ``[0, L - T]``, as
        ``lax.dynamic_slice_in_dim`` clamps its start in the JAX package."""
        if cache is None:
            cache = new_cache(len(self.decoder.block))
        dec_embeds = self._embed(decoder_input_token)
        T = decoder_input_token.shape[1]
        L = max_decode_len
        # Bias rows for the chunk's positions against the full cache length.
        full_bias = self.decoder.relative_attention_bias(L, L)
        if isinstance(step, torch.Tensor):
            start = step.clamp(0, L - T)
            rows = start[:, None] + torch.arange(T, device=step.device)
            head_bias = full_bias[:, rows].permute(1, 0, 2, 3)  # (B,H,T,L)
        else:
            start = min(max(step, 0), L - T)
            head_bias = full_bias[:, start:start + T]
        # Under MoE the chunk routes with no mask, at its own length's
        # capacity (the JAX package's decode_step passes no key mask).
        hidden, _ = self._split_aux(self.decoder(
            dec_embeds, head_bias=head_bias, enc_out=encoder_hidden,
            cross_kmask=encoder_attention_mask, cache=cache))
        return self._lm_logits(hidden), cache

    def forward(self, input_ids=None, inputs_embeds=None, attention_mask=None,
                labels=None, decoder_input_ids=None,
                decoder_attention_mask=None, label_weights=None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> Seq2SeqOutput:
        """Training forward: encode, teacher-forced decode of
        ``shift_right(labels)`` (or ``decoder_input_ids``), and the
        cross-entropy loss against ``labels`` weighted by
        ``label_weights``, plus ``moe_aux_loss_weight`` times the balance
        loss under MoE. Under sequence parallelism the logits and the loss
        are the rank's decoder positions'."""
        s = self.size
        enc, enc_aux = self._encode_with_aux(input_ids, inputs_embeds,
                                             attention_mask, deterministic,
                                             generator)
        if decoder_input_ids is None:
            decoder_input_ids = shift_right(
                labels, s.decoder_start_token_id, s.pad_token_id)
        logits, dec_aux = self._decode_train_with_aux(
            decoder_input_ids, enc, attention_mask, decoder_attention_mask,
            deterministic, generator)
        aux = None if enc_aux is None else enc_aux + dec_aux
        loss = None
        if labels is not None:
            seq = self.decoder.seq_slice(labels.shape[1])
            if label_weights is not None:
                label_weights = seq_shard(label_weights, seq)
            loss = cross_entropy_loss(logits, seq_shard(labels, seq),
                                      label_weights)
            if aux is not None:
                loss = loss + self.moe_aux_loss_weight * aux
        return Seq2SeqOutput(loss=loss, logits=logits,
                             encoder_last_hidden_state=enc, aux_loss=aux)
