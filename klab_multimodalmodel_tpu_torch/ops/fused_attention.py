"""Fused attention for the two transformers of the cascade.

Three hand-written CUDA kernels (``csrc/``) with their plain PyTorch versions:

* ``t5_attention`` forward (plain mode): ``dropout(softmax(q k^T + bias_h +
  keymask)) v`` with no 1/sqrt(d) scale, fp32 logits and softmax, masked keys
  at -1e9. Dropout acts on the probabilities; its keep bits come from
  Philox4x32-10 (``philox4x32_10`` here, ``csrc/philox.cuh`` on the card),
  a pure function of (seed, b, h, q, k).
* ``t5_attention_bwd``: dq, dk, dv and the batch-summed head-bias gradient
  (H, Q, K), with the same keep bits. ``t5_attention`` ties forward and
  backward together through ``T5AttentionFn`` whenever a gradient is needed.
* ``swin_attention`` (cosine mode): L2-normalized q and k, logits scaled by
  ``exp(min(logit_scale[h], ln 100))``, plus the continuous position bias
  and, for shifted windows, the window mask of window ``b mod nW``; the
  softmax chain in fp32 or bf16. When a gradient is needed it runs through
  ``SwinAttentionFn``, whose backward is autograd of a recompute
  (``swin_attention_reference``) in plain PyTorch, as the JAX package's is
  in XLA: there is no backward kernel.

Each wrapper takes the plain version only for tensors on the CPU; for CUDA
tensors it launches its kernel or raises. Each counts its launches in plain
integer attributes (``launches`` and, for T5, the launches at rate > 0 and
those with a bias gradient).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .cuda_build import kernel_function

NEG = -1e9
LOG_MAX_SCALE = math.log(100.0)
SWIN_MAX_TOKENS = 144  # window tokens the Swin kernel takes (12 x 12)
_DTYPES = (torch.float32, torch.bfloat16)


# ---------------------------------------------------------------------------
# Philox4x32-10 and the dropout keep bits, plain
# ---------------------------------------------------------------------------

PHILOX_M = (0xD2511F53, 0xCD9E8D57)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_MASK32 = 0xFFFFFFFF


def _mulhilo(a: int, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(high, low) 32-bit words of ``a * b`` for a 32-bit constant ``a`` and
    an int64 tensor ``b`` of 32-bit values. The 64-bit product would overflow
    int64, so ``b`` is split into 16-bit limbs: each partial product stays
    under 2^48."""
    t_lo = a * (b & 0xFFFF)
    t_hi = a * (b >> 16)
    mid = t_lo + ((t_hi & 0xFFFF) << 16)
    return (t_hi >> 16) + (mid >> 32), mid & _MASK32


def philox4x32_10(counter, key) -> tuple[torch.Tensor, ...]:
    """Philox4x32-10 on int64 tensors holding 32-bit words: ``counter`` is
    four broadcastable tensors, ``key`` two. Returns the four output words,
    bit-identical to ``csrc/philox.cuh``."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for r in range(10):
        if r:
            k0 = (k0 + PHILOX_W[0]) & _MASK32
            k1 = (k1 + PHILOX_W[1]) & _MASK32
        hi0, lo0 = _mulhilo(PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def dropout_threshold(rate: float) -> int:
    """floor(rate * 2^32): a probability is kept where its word is larger,
    as the TPU kernel compares."""
    return int(rate * 2 ** 32)


def dropout_keep_mask(seed: torch.Tensor, rate: float,
                      shape: tuple[int, int, int, int]) -> torch.Tensor:
    """Keep bits (B, H, Q, K) of the attention dropout on ``seed``'s device:
    word ``k & 3`` of Philox4x32-10 at counter (k >> 2, q, h, b) and key
    (low, high 32 bits of the int64 seed), kept where larger than
    ``dropout_threshold(rate)``."""
    B, H, Q, K = shape
    dev = seed.device
    s = seed.reshape(()).to(torch.int64)
    key = (s & _MASK32, (s >> 32) & _MASK32)
    ar = lambda n: torch.arange(n, device=dev, dtype=torch.int64)  # noqa: E731
    counter = (ar((K + 3) // 4)[None, None, None, :],
               ar(Q)[None, None, :, None], ar(H)[None, :, None, None],
               ar(B)[:, None, None, None])
    words = torch.stack(philox4x32_10(counter, key), dim=-1)
    words = words.reshape(B, H, Q, -1)[..., :K]
    return words > dropout_threshold(rate)


def draw_seed(generator: torch.Generator) -> torch.Tensor:
    """A fresh int64 dropout seed, one element on the generator's device:
    the kernels read it by pointer, so drawing it needs no host sync."""
    return torch.randint(0, 2 ** 63 - 1, (1,), generator=generator,
                         device=generator.device, dtype=torch.int64)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def _t5_logits(q, k, bias_h, kmask) -> torch.Tensor:
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
    if bias_h is not None:
        logits = logits + bias_h.float()
    if kmask is not None:
        logits = logits + torch.where(kmask[:, None, None, :] > 0, 0.0, NEG)
    return logits


def t5_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       bias_h: Optional[torch.Tensor] = None,
                       kmask: Optional[torch.Tensor] = None,
                       dropout_rate: float = 0.0,
                       seed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (B,H,Q,D), k/v (B,H,K,D), bias_h (H,Q,K), kmask (B,K) with >0 =
    attend, seed a one-element int64 tensor (needed at rate > 0). fp32
    logits and softmax; the dropped, rescaled probabilities cast to v's dtype
    before the product; output in q's dtype."""
    p = _softmax(_t5_logits(q, k, bias_h, kmask))
    if dropout_rate > 0:
        keep = dropout_keep_mask(seed, dropout_rate, tuple(p.shape))
        p = torch.where(keep, p / (1.0 - dropout_rate), 0.0)
    return torch.matmul(p.to(v.dtype).float(), v.float()).to(q.dtype)


def t5_attention_bwd_plain(q, k, v, dout, bias_h=None, kmask=None,
                           dropout_rate: float = 0.0, seed=None,
                           need_dbias: bool = False):
    """Gradients of ``t5_attention_plain`` with the TPU kernel's roundings:
    P fp32; dv = Pd^T dO with Pd in the io dtype; dP = dO v^T, masked and
    rescaled by the same keep bits; dS = P (dP - sum dP P) fp32, cast to the
    io dtype for dq = dS k and dk = dS^T q. Returns (dq, dk, dv, dbias) with
    dbias (H,Q,K) fp32 = sum over the batch of dS, or None."""
    io = q.dtype
    p = _softmax(_t5_logits(q, k, bias_h, kmask))
    p_drop = p
    do = dout.to(io).float()
    dp = torch.matmul(do, v.float().transpose(-1, -2))
    if dropout_rate > 0:
        keep = dropout_keep_mask(seed, dropout_rate, tuple(p.shape))
        p_drop = torch.where(keep, p / (1.0 - dropout_rate), 0.0)
        dp = torch.where(keep, dp / (1.0 - dropout_rate), 0.0)
    dv = torch.matmul(p_drop.to(io).float().transpose(-1, -2), do)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    ds_c = ds.to(io).float()
    dq = torch.matmul(ds_c, k.float())
    dk = torch.matmul(ds_c.transpose(-1, -2), q.float())
    dbias = ds.sum(0) if need_dbias else None
    return dq.to(io), dk.to(io), dv.to(io), dbias


def swin_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         logit_scale: torch.Tensor, bias_h: torch.Tensor,
                         window_mask: Optional[torch.Tensor] = None,
                         softmax_dtype: torch.dtype = torch.float32
                         ) -> torch.Tensor:
    """q/k/v (Bn,H,N,D), logit_scale (H,) raw, bias_h (H,N,N), window_mask
    (nW,N,N) or None. q and k normalize as ``x * rsqrt(sum x^2 + 1e-24)`` in
    fp32 and cast back to the input dtype; the logits chain runs in
    ``softmax_dtype``."""
    qn = _l2_normalize(q).to(q.dtype).float()
    kn = _l2_normalize(k).to(k.dtype).float()
    p = _softmax(_swin_logits(qn, kn, logit_scale, bias_h, window_mask,
                              softmax_dtype))
    return torch.matmul(p.to(v.dtype).float(), v.float()).to(v.dtype)


def swin_attention_reference(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, logit_scale: torch.Tensor,
                             bias_h: torch.Tensor,
                             window_mask: Optional[torch.Tensor] = None,
                             softmax_dtype: torch.dtype = torch.float32
                             ) -> torch.Tensor:
    """The function the Swin backward differentiates, the JAX package's
    recompute reference: q and k normalized in fp32 and kept fp32 through
    the product (``swin_attention_plain`` casts them back to the input
    dtype, as the kernel does), the logits chain in ``softmax_dtype``, the
    probabilities cast to v's dtype before an fp32-accumulated product."""
    logits = _swin_logits(_l2_normalize(q), _l2_normalize(k), logit_scale,
                          bias_h, window_mask, softmax_dtype)
    p = torch.softmax(logits, dim=-1)
    return torch.matmul(p.to(v.dtype).float(), v.float()).to(v.dtype)


def _swin_logits(qn, kn, logit_scale, bias_h, window_mask, sm):
    """The cosine logits from fp32 normalized q and k, in ``sm``: the
    product, times the clamped scale, plus the bias and the window mask of
    window ``b mod nW``."""
    logits = torch.matmul(qn, kn.transpose(-1, -2)).to(sm)
    s = torch.exp(torch.clamp(logit_scale.float(), max=LOG_MAX_SCALE)).to(sm)
    logits = logits * s[None, :, None, None]
    logits = logits + bias_h.to(sm)[None]
    if window_mask is not None:
        nW = window_mask.shape[0]
        tiled = window_mask.to(sm).repeat(qn.shape[0] // nW, 1, 1)
        logits = logits + tiled[:, None]
    return logits


def _l2_normalize(x: torch.Tensor) -> torch.Tensor:
    """x * rsqrt(sum x^2 + 1e-24) over the last dim, in fp32."""
    x32 = x.float()
    return x32 * torch.rsqrt((x32 * x32).sum(-1, keepdim=True) + 1e-24)


def _softmax(logits: torch.Tensor) -> torch.Tensor:
    """max-subtract, exp, divide by the sum: the TPU kernel's order, in the
    logits' dtype."""
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    return p / p.sum(-1, keepdim=True)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def t5_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 bias_h: Optional[torch.Tensor] = None,
                 kmask: Optional[torch.Tensor] = None,
                 dropout_rate: float = 0.0,
                 seed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """T5 attention (see ``t5_attention_plain`` for the function): the
    forward kernel ``csrc/t5_attention_fwd.cu`` and, when autograd needs a
    gradient of q, k, v or ``bias_h``, the backward kernel through
    ``T5AttentionFn``. ``bias_h`` must be fp32, ``kmask`` int32 and ``seed``
    a one-element int64 tensor on the card; ``seed`` is needed at rate > 0.
    """
    _check_rate(dropout_rate, seed)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (q, k, v, bias_h)):
        return T5AttentionFn.apply(q, k, v, bias_h, kmask, seed,
                                   float(dropout_rate))
    return t5_attention_fwd(q, k, v, bias_h, kmask, dropout_rate, seed)[0]


t5_attention.launches = 0
t5_attention.launches_dropout = 0  # of those, at rate > 0


def t5_attention_fwd(q, k, v, bias_h=None, kmask=None, dropout_rate=0.0,
                     seed=None, with_stats: bool = False):
    """(output, row stats (B,H,Q,2) fp32 or None): the forward kernel
    ``csrc/t5_attention_fwd.cu`` on CUDA tensors (the stats are the row max
    and sum the backward reuses), the plain version (no stats) on CPU
    tensors. No autograd: ``t5_attention`` is the entry point."""
    if q.device.type == "cpu":
        return t5_attention_plain(q, k, v, bias_h, kmask, dropout_rate,
                                  seed), None
    B, H, Q, D = q.shape
    K = k.shape[2]
    _check_t5(q, k, v, bias_h, kmask, seed, dropout_rate)
    out = torch.empty_like(q)
    stats = (torch.empty(B, H, Q, 2, device=q.device, dtype=torch.float32)
             if with_stats else None)
    rate = float(dropout_rate)
    with torch.cuda.device(q.device):
        err = kernel_function("t5_attention_fwd")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(bias_h),
            _ptr(kmask), _ptr(seed) if rate > 0 else None, out.data_ptr(),
            _ptr(stats), B, H, Q, K, D, int(q.dtype == torch.bfloat16), rate,
            torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on_error(err, "t5_attention_fwd")
    t5_attention.launches += 1
    if rate > 0:
        t5_attention.launches_dropout += 1
    return out, stats


def t5_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     dout: torch.Tensor,
                     bias_h: Optional[torch.Tensor] = None,
                     kmask: Optional[torch.Tensor] = None,
                     dropout_rate: float = 0.0,
                     seed: Optional[torch.Tensor] = None,
                     stats: Optional[torch.Tensor] = None,
                     need_dbias: bool = False):
    """(dq, dk, dv, dbias or None) of T5 attention through
    ``csrc/t5_attention_bwd.cu`` (see ``t5_attention_bwd_plain``). On CUDA
    tensors ``stats`` is required: the (B,H,Q,2) row max and sum that
    ``t5_attention_fwd(..., with_stats=True)`` wrote; the plain version on
    CPU tensors needs none. ``need_dbias`` needs ``bias_h``."""
    _check_rate(dropout_rate, seed)
    if need_dbias and bias_h is None:
        raise ValueError("t5_attention_bwd: need_dbias without a bias")
    if q.device.type == "cpu":
        return t5_attention_bwd_plain(q, k, v, dout, bias_h, kmask,
                                      dropout_rate, seed, need_dbias)
    B, H, Q, D = q.shape
    K = k.shape[2]
    _check_t5(q, k, v, bias_h, kmask, seed, dropout_rate)
    _check_aux(dout, "dout", (B, H, Q, D), q.dtype, q.device)
    if stats is None:
        raise ValueError("t5_attention_bwd: stats required on the card "
                         "(t5_attention_fwd(..., with_stats=True))")
    _check_aux(stats, "stats", (B, H, Q, 2), torch.float32, q.device)
    delta = torch.empty(B, H, Q, device=q.device, dtype=torch.float32)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    ds = dbias = None
    if need_dbias:
        ds = torch.empty(B, H, Q, K, device=q.device, dtype=torch.float32)
        dbias = torch.empty(H, Q, K, device=q.device, dtype=torch.float32)
    rate = float(dropout_rate)
    with torch.cuda.device(q.device):
        err = kernel_function("t5_attention_bwd")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            _ptr(bias_h), _ptr(kmask), _ptr(seed) if rate > 0 else None,
            stats.data_ptr(), delta.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), _ptr(ds),
            _ptr(dbias), B, H, Q, K, D, int(q.dtype == torch.bfloat16), rate,
            torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on_error(err, "t5_attention_bwd")
    t5_attention_bwd.launches += 1
    if need_dbias:
        t5_attention_bwd.launches_dbias += 1
    return dq, dk, dv, dbias


t5_attention_bwd.launches = 0
t5_attention_bwd.launches_dbias = 0  # of those, with the bias gradient


class T5AttentionFn(torch.autograd.Function):
    """T5 attention with its backward: the two kernels on CUDA tensors, the
    plain forward and the plain backward (an explicit function with the
    kernel's math, not autograd of the plain forward) on CPU tensors. The
    seed and the forward's row stats are saved, so the backward draws the
    forward's keep bits again. No gradient flows to the key mask or the
    seed."""

    @staticmethod
    def forward(ctx, q, k, v, bias_h, kmask, seed, dropout_rate):
        out, stats = t5_attention_fwd(q, k, v, bias_h, kmask, dropout_rate,
                                      seed, with_stats=True)
        ctx.dropout_rate = dropout_rate
        ctx.save_for_backward(q, k, v, bias_h, kmask, seed, stats)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, bias_h, kmask, seed, stats = ctx.saved_tensors
        need_dbias = bias_h is not None and ctx.needs_input_grad[3]
        dq, dk, dv, dbias = t5_attention_bwd(
            q, k, v, dout.contiguous(), bias_h, kmask, ctx.dropout_rate,
            seed, stats, need_dbias)
        return dq, dk, dv, dbias, None, None, None


def swin_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   logit_scale: torch.Tensor, bias_h: torch.Tensor,
                   window_mask: Optional[torch.Tensor] = None,
                   softmax_dtype: torch.dtype = torch.float32
                   ) -> torch.Tensor:
    """SwinV2 cosine window attention (see ``swin_attention_plain``): the
    forward kernel ``csrc/swin_attention_fwd.cu`` and, when autograd needs
    a gradient of q, k, v, ``logit_scale`` or ``bias_h``, the recompute
    backward through ``SwinAttentionFn``. ``logit_scale`` (H,), ``bias_h``
    and ``window_mask`` must be fp32 on the card; ``softmax_dtype`` is
    float32 or bfloat16. The kernel takes windows of at most
    ``SWIN_MAX_TOKENS`` (144, a 12 x 12 window) tokens and head dims of at
    most 128; a larger CUDA input raises ``ValueError``."""
    if softmax_dtype not in _DTYPES:
        raise ValueError(f"swin_attention: softmax_dtype {softmax_dtype}: "
                         "expected float32 or bfloat16")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v, logit_scale, bias_h)):
        return SwinAttentionFn.apply(q, k, v, logit_scale, bias_h,
                                     window_mask, softmax_dtype)
    return swin_attention_fwd(q, k, v, logit_scale, bias_h, window_mask,
                              softmax_dtype)


swin_attention.launches = 0


def swin_attention_fwd(q, k, v, logit_scale, bias_h, window_mask=None,
                       softmax_dtype: torch.dtype = torch.float32
                       ) -> torch.Tensor:
    """The forward kernel on CUDA tensors, the plain version on CPU tensors.
    No autograd: ``swin_attention`` is the entry point."""
    if q.device.type == "cpu":
        return swin_attention_plain(q, k, v, logit_scale, bias_h,
                                    window_mask, softmax_dtype)
    Bn, H, N, D = q.shape
    if N > SWIN_MAX_TOKENS or D > 128:
        raise ValueError(f"swin_attention: {N} tokens of head dim {D}: the "
                         f"kernel takes at most {SWIN_MAX_TOKENS} tokens and "
                         "a head dim of at most 128")
    _check_qkv(q, k, v, (Bn, H, N, D))
    _check_aux(logit_scale, "logit_scale", (H,), torch.float32, q.device)
    _check_aux(bias_h, "bias_h", (H, N, N), torch.float32, q.device)
    nW = 0
    if window_mask is not None:
        nW = window_mask.shape[0]
        _check_aux(window_mask, "window_mask", (nW, N, N), torch.float32,
                   q.device)
        if Bn % nW:
            raise ValueError(f"swin_attention: {Bn} windows is not a "
                             f"multiple of the mask's {nW}")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = kernel_function("swin_attention_fwd")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), logit_scale.data_ptr(),
            bias_h.data_ptr(), _ptr(window_mask), out.data_ptr(), Bn, H, N,
            D, nW, int(q.dtype == torch.bfloat16),
            int(softmax_dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on_error(err, "swin_attention_fwd")
    swin_attention.launches += 1
    return out


class SwinAttentionFn(torch.autograd.Function):
    """Swin attention with its backward: the forward kernel on CUDA tensors
    (the plain version on CPU tensors); the backward is autograd of
    ``swin_attention_reference`` recomputed from the saved inputs, in the
    forward's ``softmax_dtype``, as the JAX package's custom VJP is. It
    gives dq, dk, dv, d(logit scale) and d(bias); the window mask takes no
    gradient."""

    @staticmethod
    def forward(ctx, q, k, v, logit_scale, bias_h, window_mask,
                softmax_dtype):
        ctx.softmax_dtype = softmax_dtype
        ctx.save_for_backward(q, k, v, logit_scale, bias_h, window_mask)
        return swin_attention_fwd(q, k, v, logit_scale, bias_h, window_mask,
                                  softmax_dtype)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, logit_scale, bias_h, window_mask = ctx.saved_tensors
        leaves = [t.detach().requires_grad_(need) for t, need in zip(
            (q, k, v, logit_scale, bias_h), ctx.needs_input_grad[:5])]
        wanted = [t for t in leaves if t.requires_grad]
        with torch.enable_grad():
            out = swin_attention_reference(*leaves, window_mask,
                                           ctx.softmax_dtype)
            got = iter(torch.autograd.grad(out, wanted, dout))
        grads = [next(got) if t.requires_grad else None for t in leaves]
        return (*grads, None, None)


def _check_rate(rate: float, seed) -> None:
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate {rate}: expected 0 <= rate < 1")
    if rate > 0 and seed is None:
        raise ValueError("dropout rate > 0 needs a seed (see draw_seed)")


def _check_t5(q, k, v, bias_h, kmask, seed, rate) -> None:
    B, H, Q, D = q.shape
    K = k.shape[2]
    _check_qkv(q, k, v, (B, H, K, D))
    if D > 128:
        raise ValueError(f"t5_attention: head dim {D} > 128 is not supported")
    _check_aux(bias_h, "bias_h", (H, Q, K), torch.float32, q.device)
    _check_aux(kmask, "kmask", (B, K), torch.int32, q.device)
    if rate > 0:
        _check_aux(seed, "seed", (1,), torch.int64, q.device)


def _check_qkv(q, k, v, kv_shape) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"expected CPU or CUDA tensors, got {q.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"q dtype {q.dtype}: expected float32 or bfloat16")
    for name, t, shape in (("k", k, kv_shape), ("v", v, kv_shape)):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype} on {t.device}; q is "
                             f"{q.dtype} on {q.device}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} shape {tuple(t.shape)}, expected "
                             f"{tuple(shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_aux(t, name, shape, dtype, device) -> None:
    if t is None:
        return
    if t.device != device or t.dtype != dtype:
        raise ValueError(f"{name} is {t.dtype} on {t.device}; expected "
                         f"{dtype} on {device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _raise_on_error(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")
