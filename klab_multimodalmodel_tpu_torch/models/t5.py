"""T5 encoder-decoder (v1.0 and v1.1/Flan geometries), dense subset.

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
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint as ckpt
from torch import nn

from ..config import T5Size
from ..ops.fused_attention import draw_seed, t5_attention
from ..utils.device import resolve_device
from .layers import (NEG_INF, Dense, RMSNorm, dot_product_attention, dropout,
                     normal_)

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


class T5RelativePositionBias(nn.Module):
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

    def forward(self, query_length: int, key_length: int) -> torch.Tensor:
        device = self.weight.device
        ctx = torch.arange(query_length, device=device)[:, None]
        mem = torch.arange(key_length, device=device)[None, :]
        buckets = relative_position_bucket(
            mem - ctx, bidirectional=self.bidirectional,
            num_buckets=self.num_buckets, max_distance=self.max_distance)
        return self.weight[buckets].permute(2, 0, 1)  # (H, Lq, Lk)

    def init_weights(self, generator: torch.Generator) -> None:
        normal_(self.weight, 1.0, generator)


# ---------------------------------------------------------------------------
# Dense
# ---------------------------------------------------------------------------


class KlabDense(Dense):
    """Bias-free dense layer (torch layout: weight (out, in)) in the compute
    dtype, with the T5 fan-in normal init of its JAX counterpart."""

    def __init__(self, in_features: int, out_features: int, init_std: float,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias=False,
                         compute_dtype=compute_dtype)
        self.init_std = init_std

    def init_weights(self, generator: torch.Generator) -> None:
        normal_(self.weight, self.init_std, generator)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


class T5Attention(nn.Module):
    """Multi-head attention without the 1/sqrt(d) scale (T5 convention).

    Modes: full-sequence self-attention, cross-attention (``kv`` given),
    and incremental decode (``cache`` given) against a fixed-shape KV cache
    with a scalar write index. ``kernel_pack`` = (head bias (H,Q,K) fp32,
    key mask (B,K) int32), either may be None, routes full-sequence
    attention through the hand-written kernel.
    """

    def __init__(self, size: T5Size, has_relative_attention_bias: bool = False,
                 bidirectional: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        s = self.size = size
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

    def init_weights(self, generator: torch.Generator) -> None:
        for layer in (self.q, self.k, self.v, self.o):
            layer.init_weights(generator)
        if hasattr(self, "relative_attention_bias"):
            self.relative_attention_bias.init_weights(generator)

    def _split_heads(self, t: torch.Tensor) -> torch.Tensor:
        B, L, _ = t.shape
        return t.view(B, L, self.size.num_heads, self.size.d_kv).transpose(
            1, 2)  # (B, H, L, D)

    def _merge_heads(self, t: torch.Tensor) -> torch.Tensor:
        B, H, L, D = t.shape
        return t.transpose(1, 2).reshape(B, L, H * D)

    def forward(self, x: torch.Tensor, kv: Optional[torch.Tensor] = None,
                bias: Optional[torch.Tensor] = None,
                kernel_pack: Optional[tuple] = None,
                cache: Optional[dict] = None, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        q = self._split_heads(self.q(x))
        is_cross = kv is not None
        rate = 0.0 if deterministic or cache is not None else (
            self.size.dropout_rate)
        if cache is not None:
            k, v, bias = self._decode_kv(x, kv, bias, cache)
        else:
            src = kv if is_cross else x
            k = self._split_heads(self.k(src))
            v = self._split_heads(self.v(src))
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
                                    seed)
                return self.o(self._merge_heads(attn))
        attn = dot_product_attention(q, k, v, bias=bias, dropout_rate=rate,
                                     generator=generator)
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
            cache["cached_key"] = k.new_zeros(B, H, max_len, D)
            cache["cached_value"] = v.new_zeros(B, H, max_len, D)
            cache["cache_index"] = 0
        i = cache["cache_index"]
        ck, cv = cache["cached_key"], cache["cached_value"]
        ck[:, :, i:i + T] = k
        cv[:, :, i:i + T] = v
        cache["cache_index"] = i + T
        # Mask cache slots not yet written, causal per query row: the j-th
        # query of a chunk sees positions up to i + j.
        max_len = ck.shape[2]
        q_pos = (i + torch.arange(T, device=x.device))[None, None, :, None]
        pos = torch.arange(max_len, device=x.device)[None, None, None, :]
        step_bias = torch.where(pos <= q_pos, 0.0, NEG_INF)
        bias = step_bias if bias is None else bias + step_bias
        return ck, cv, bias


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


class T5Mlp(nn.Module):
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

    def init_weights(self, generator: torch.Generator) -> None:
        for layer in ((self.wi_0, self.wi_1) if self.gated else (self.wi,)):
            layer.init_weights(generator)
        self.wo.init_weights(generator)

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.gated:
            h = self.act(self.wi_0(x)) * self.wi_1(x)
        else:
            h = self.act(self.wi(x))
        rate = 0.0 if deterministic else self.size.dropout_rate
        return self.wo(dropout(h, rate, generator))


class T5Block(nn.Module):
    """Pre-norm residual block: self-attn [-> cross-attn] -> MLP, laid out
    as HF's ``layer`` list so parameter names match."""

    def __init__(self, size: T5Size, has_cross_attention: bool,
                 has_relative_attention_bias: bool,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        s = self.size = size
        self.has_cross_attention = has_cross_attention
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
        layers.append(nn.ModuleDict({
            "layer_norm": RMSNorm(s.d_model, eps),
            "DenseReluDense": T5Mlp(s, dtype)}))
        self.layer = nn.ModuleList(layers)

    def init_weights(self, generator: torch.Generator) -> None:
        for sub in self.layer:
            for m in sub.values():
                m.init_weights(generator)

    def forward(self, x, self_bias, enc_out, cross_bias, self_pack=None,
                cross_pack=None, cache: Optional[dict] = None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        rate = 0.0 if deterministic else self.size.dropout_rate
        sa = self.layer[0]
        h = sa["SelfAttention"](sa["layer_norm"](x), bias=self_bias,
                                kernel_pack=self_pack,
                                cache=None if cache is None else cache["self"],
                                deterministic=deterministic,
                                generator=generator)
        x = x + dropout(h, rate, generator)
        if self.has_cross_attention:
            ca = self.layer[1]
            h = ca["EncDecAttention"](
                ca["layer_norm"](x), kv=enc_out, bias=cross_bias,
                kernel_pack=cross_pack,
                cache=None if cache is None else cache["cross"],
                deterministic=deterministic, generator=generator)
            x = x + dropout(h, rate, generator)
        ff = self.layer[-1]
        h = ff["DenseReluDense"](ff["layer_norm"](x), deterministic,
                                 generator)
        return x + dropout(h, rate, generator)


def _mask_to_bias(mask: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """(B, K) key mask -> (B, 1, 1, K) additive fp32 bias."""
    if mask is None:
        return None
    return torch.where(mask[:, None, None, :] > 0, 0.0, NEG_INF)


def _assemble_dense_biases(head_bias, kmask, enc_out, cross_kmask):
    """Reference-path logit biases from the decomposed attention inputs:
    the shared (H, Q, K) head bias broadcast over batch plus the key-mask
    bias, and the cross-attention key-mask bias."""
    self_bias = None if head_bias is None else head_bias[None]
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


class T5Stack(nn.Module):
    """Encoder or decoder stack (embedding handled by the caller).

    Callers pass the decomposed attention inputs: a shared per-head bias
    ``head_bias`` (H, Q, K) and raw key masks ``kmask``/``cross_kmask``
    (B, K). The reference path sums them into dense logit biases; the kernel
    path (``use_pallas``) hands them to the kernel unchanged. ``remat``
    checkpoints each block when autograd records (see ``_remat_block``).
    """

    def __init__(self, size: T5Size, num_layers: int, is_decoder: bool,
                 use_pallas: bool = False, dtype: torch.dtype = torch.float32,
                 remat: str = ""):
        super().__init__()
        self.size = size
        self.use_pallas = use_pallas
        self.remat = remat
        self.block = nn.ModuleList(
            T5Block(size, is_decoder, has_relative_attention_bias=(i == 0),
                    dtype=dtype)
            for i in range(num_layers))
        self.final_layer_norm = RMSNorm(size.d_model, size.layer_norm_epsilon)

    @property
    def relative_attention_bias(self) -> T5RelativePositionBias:
        return self.block[0].layer[0]["SelfAttention"].relative_attention_bias

    def init_weights(self, generator: torch.Generator) -> None:
        for blk in self.block:
            blk.init_weights(generator)
        self.final_layer_norm.init_weights(generator)

    def forward(self, inputs_embeds: torch.Tensor,
                head_bias: Optional[torch.Tensor] = None,
                kmask: Optional[torch.Tensor] = None,
                enc_out: Optional[torch.Tensor] = None,
                cross_kmask: Optional[torch.Tensor] = None,
                cache: Optional[Cache] = None, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        deterministic = deterministic or cache is not None
        rate = 0.0 if deterministic else self.size.dropout_rate
        x = dropout(inputs_embeds, rate, generator)
        self_bias = cross_bias = self_pack = cross_pack = None
        if self.use_pallas and cache is None:
            self_pack = (_kernel_bias(head_bias), _kernel_mask(kmask))
            if enc_out is not None:
                cross_pack = (None, _kernel_mask(cross_kmask))
        else:
            self_bias, cross_bias = _assemble_dense_biases(
                head_bias, kmask, enc_out, cross_kmask)
        remat = self.remat if torch.is_grad_enabled() and cache is None else ""
        kw = dict(self_bias=self_bias, enc_out=enc_out, cross_bias=cross_bias,
                  self_pack=self_pack, cross_pack=cross_pack,
                  deterministic=deterministic)
        for i, blk in enumerate(self.block):
            if remat:
                x = _remat_block(blk, remat, x, generator, **kw)
            else:
                x = blk(x, cache=None if cache is None else cache[i],
                        generator=generator, **kw)
        return dropout(self.final_layer_norm(x), rate, generator)


def _kernel_bias(bias: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if bias is None else bias.float().contiguous()


def _kernel_mask(mask: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if mask is None else mask.to(torch.int32).contiguous()


# ---------------------------------------------------------------------------
# Top-level models
# ---------------------------------------------------------------------------


class T5Encoder(nn.Module):
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
                                   use_pallas=use_pallas, dtype=dtype)

    def init_weights(self, generator: torch.Generator) -> None:
        normal_(self.shared.weight, 1.0, generator)
        self.encoder.init_weights(generator)

    def forward(self, input_ids: Optional[torch.Tensor] = None,
                inputs_embeds: Optional[torch.Tensor] = None,
                attention_mask: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if inputs_embeds is None:
            inputs_embeds = self.shared(input_ids.long()).to(self.dtype)
        L = inputs_embeds.shape[1]
        relpos = self.encoder.relative_attention_bias
        return self.encoder(inputs_embeds, head_bias=relpos(L, L),
                            kmask=attention_mask,
                            deterministic=deterministic, generator=generator)


def new_cache(num_layers: int) -> Cache:
    """An empty decode cache; the first ``decode_step`` fills it."""
    return [{"self": {}, "cross": {}} for _ in range(num_layers)]


@dataclasses.dataclass
class Seq2SeqOutput:
    loss: Optional[torch.Tensor]
    logits: torch.Tensor
    encoder_last_hidden_state: torch.Tensor


def causal_bias(length: int, device=None) -> torch.Tensor:
    """(L, L) fp32: 0 where the key is at or before the query, else -1e9."""
    idx = torch.arange(length, device=device)
    return torch.where(idx[:, None] >= idx[None, :], 0.0, NEG_INF)


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


class T5ForConditionalGeneration(nn.Module):
    """Full encoder-decoder with the tied (or untied) LM head.

    ``dtype``: the compute dtype. ``remat``: '', 'full' or 'dots_saveable'
    (see ``_remat_block``). ``device``: None means the card (see
    ``utils.device``)."""

    def __init__(self, size: T5Size, use_pallas: bool = False,
                 dtype: torch.dtype = torch.float32, remat: str = "",
                 device=None):
        super().__init__()
        with torch.device(resolve_device(device)):
            s = self.size = size
            self.dtype = dtype
            self.shared = nn.Embedding(s.vocab_size, s.d_model)
            self.encoder = T5Stack(s, s.num_layers, is_decoder=False,
                                   use_pallas=use_pallas, dtype=dtype,
                                   remat=remat)
            self.decoder = T5Stack(s, s.num_decoder_layers, is_decoder=True,
                                   use_pallas=use_pallas, dtype=dtype,
                                   remat=remat)
            if not s.tie_word_embeddings:
                self.lm_head = KlabDense(s.d_model, s.vocab_size,
                                         s.d_model ** -0.5, dtype)

    def init_weights(self, generator: torch.Generator) -> None:
        normal_(self.shared.weight, 1.0, generator)
        self.encoder.init_weights(generator)
        self.decoder.init_weights(generator)
        if not self.size.tie_word_embeddings:
            self.lm_head.init_weights(generator)

    def _embed(self, ids: torch.Tensor) -> torch.Tensor:
        return self.shared(ids.long()).to(self.dtype)

    def encode(self, input_ids=None, inputs_embeds=None,
               attention_mask=None, deterministic: bool = True,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if inputs_embeds is None:
            inputs_embeds = self._embed(input_ids)
        L = inputs_embeds.shape[1]
        relpos = self.encoder.relative_attention_bias
        return self.encoder(inputs_embeds, head_bias=relpos(L, L),
                            kmask=attention_mask,
                            deterministic=deterministic, generator=generator)

    def _lm_logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """Logits in the compute dtype (flax ``Embed.attend`` for the tied
        head)."""
        s = self.size
        if s.tie_word_embeddings:
            return F.linear((hidden * (s.d_model ** -0.5)).to(self.dtype),
                            self.shared.weight.to(self.dtype))
        return self.lm_head(hidden)

    def decode_train(self, decoder_input_ids: torch.Tensor,
                     encoder_hidden: torch.Tensor,
                     encoder_attention_mask: Optional[torch.Tensor] = None,
                     decoder_attention_mask: Optional[torch.Tensor] = None,
                     deterministic: bool = True,
                     generator: Optional[torch.Generator] = None
                     ) -> torch.Tensor:
        """Teacher-forced decoder over the whole target: (B, L) ids ->
        (B, L, vocab) logits. The self-attention bias is the relative-
        position bias plus the causal mask."""
        L = decoder_input_ids.shape[1]
        head_bias = (self.decoder.relative_attention_bias(L, L)
                     + causal_bias(L, decoder_input_ids.device))
        hidden = self.decoder(self._embed(decoder_input_ids),
                              head_bias=head_bias,
                              kmask=decoder_attention_mask,
                              enc_out=encoder_hidden,
                              cross_kmask=encoder_attention_mask,
                              deterministic=deterministic,
                              generator=generator)
        return self._lm_logits(hidden)

    def decode_step(self, decoder_input_token: torch.Tensor, step: int,
                    encoder_hidden: torch.Tensor, max_decode_len: int,
                    encoder_attention_mask: Optional[torch.Tensor] = None,
                    cache: Optional[Cache] = None
                    ) -> tuple[torch.Tensor, Cache]:
        """One incremental decode step: ``decoder_input_token`` (B, T)
        starts at cache position ``step`` (a Python int; all rows at the
        same position). ``cache=None`` starts a new cache. Returns
        ((B, T, vocab) logits, the cache, updated in place)."""
        if cache is None:
            cache = new_cache(len(self.decoder.block))
        dec_embeds = self._embed(decoder_input_token)
        T = decoder_input_token.shape[1]
        # Bias rows for the chunk's positions against the full cache length.
        full_bias = self.decoder.relative_attention_bias(max_decode_len,
                                                         max_decode_len)
        head_bias = full_bias[:, step:step + T]
        hidden = self.decoder(dec_embeds, head_bias=head_bias,
                              enc_out=encoder_hidden,
                              cross_kmask=encoder_attention_mask, cache=cache)
        return self._lm_logits(hidden), cache

    def forward(self, input_ids=None, inputs_embeds=None, attention_mask=None,
                labels=None, decoder_input_ids=None,
                decoder_attention_mask=None, label_weights=None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> Seq2SeqOutput:
        """Training forward: encode, teacher-forced decode of
        ``shift_right(labels)`` (or ``decoder_input_ids``), and the
        cross-entropy loss against ``labels`` weighted by
        ``label_weights``."""
        s = self.size
        enc = self.encode(input_ids, inputs_embeds, attention_mask,
                          deterministic, generator)
        if decoder_input_ids is None:
            decoder_input_ids = shift_right(
                labels, s.decoder_start_token_id, s.pad_token_id)
        logits = self.decode_train(decoder_input_ids, enc,
                                   encoder_attention_mask=attention_mask,
                                   decoder_attention_mask=decoder_attention_mask,
                                   deterministic=deterministic,
                                   generator=generator)
        loss = None
        if labels is not None:
            loss = cross_entropy_loss(logits, labels, label_weights)
        return Seq2SeqOutput(loss=loss, logits=logits,
                             encoder_last_hidden_state=enc)
