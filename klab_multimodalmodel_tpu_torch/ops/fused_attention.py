"""Fused attention for the two transformers of the cascade.

Two hand-written CUDA kernels (``csrc/``) with their plain PyTorch versions:

* ``t5_attention`` (plain mode): ``softmax(q k^T + bias_h + keymask) v``
  with no 1/sqrt(d) scale, fp32 logits and softmax, masked keys at -1e9;
* ``swin_attention`` (cosine mode): L2-normalized q and k, logits scaled by
  ``exp(min(logit_scale[h], ln 100))``, plus the continuous position bias
  and, for shifted windows, the window mask of window ``b mod nW``.

Each wrapper takes the plain version only for tensors on the CPU; for CUDA
tensors it launches its kernel or raises. Each counts its launches in a
plain integer attribute, ``launches``. Dropout (rate > 0) and a bf16 softmax
chain are not ported yet, and both wrappers refuse them on every device.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .cuda_build import kernel_function

NEG = -1e9
LOG_MAX_SCALE = math.log(100.0)
_DTYPES = (torch.float32, torch.bfloat16)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def t5_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       bias_h: Optional[torch.Tensor] = None,
                       kmask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (B,H,Q,D), k/v (B,H,K,D), bias_h (H,Q,K), kmask (B,K) with >0 =
    attend. fp32 logits and softmax; probabilities cast to v's dtype before
    the product; output in q's dtype."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
    if bias_h is not None:
        logits = logits + bias_h.float()
    if kmask is not None:
        logits = logits + torch.where(kmask[:, None, None, :] > 0, 0.0, NEG)
    p = _softmax(logits)
    return torch.matmul(p.to(v.dtype).float(), v.float()).to(q.dtype)


def swin_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         logit_scale: torch.Tensor, bias_h: torch.Tensor,
                         window_mask: Optional[torch.Tensor] = None,
                         softmax_dtype: torch.dtype = torch.float32
                         ) -> torch.Tensor:
    """q/k/v (Bn,H,N,D), logit_scale (H,) raw, bias_h (H,N,N), window_mask
    (nW,N,N) or None. q and k normalize as ``x * rsqrt(sum x^2 + 1e-24)`` in
    fp32 and cast back to the input dtype; the logits chain runs in
    ``softmax_dtype``."""
    sm = softmax_dtype
    qn = _l2_normalize(q)
    kn = _l2_normalize(k)
    logits = torch.matmul(qn.float(), kn.float().transpose(-1, -2)).to(sm)
    s = torch.exp(torch.clamp(logit_scale.float(), max=LOG_MAX_SCALE)).to(sm)
    logits = logits * s[None, :, None, None]
    logits = logits + bias_h.to(sm)[None]
    if window_mask is not None:
        nW = window_mask.shape[0]
        tiled = window_mask.to(sm).repeat(q.shape[0] // nW, 1, 1)
        logits = logits + tiled[:, None]
    p = _softmax(logits)
    return torch.matmul(p.to(v.dtype).float(), v.float()).to(v.dtype)


def _l2_normalize(x: torch.Tensor) -> torch.Tensor:
    x32 = x.float()
    return (x32 * torch.rsqrt((x32 * x32).sum(-1, keepdim=True) + 1e-24)
            ).to(x.dtype)


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
                 dropout_rate: float = 0.0) -> torch.Tensor:
    """T5 attention through ``csrc/t5_attention_fwd.cu`` (see
    ``t5_attention_plain`` for the function). ``bias_h`` must be fp32 and
    ``kmask`` int32 on the card."""
    if dropout_rate > 0:
        raise NotImplementedError(
            "in-kernel attention dropout (rate > 0) is not ported yet")
    if q.device.type == "cpu":
        return t5_attention_plain(q, k, v, bias_h, kmask)
    B, H, Q, D = q.shape
    K = k.shape[2]
    _check_qkv(q, k, v, (B, H, K, D))
    if D > 128:
        raise ValueError(f"t5_attention: head dim {D} > 128 is not supported")
    _check_aux(bias_h, "bias_h", (H, Q, K), torch.float32, q.device)
    _check_aux(kmask, "kmask", (B, K), torch.int32, q.device)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = kernel_function("t5_attention_fwd")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(bias_h),
            _ptr(kmask), out.data_ptr(), B, H, Q, K, D,
            int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on_error(err, "t5_attention_fwd")
    t5_attention.launches += 1
    return out


t5_attention.launches = 0


def swin_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   logit_scale: torch.Tensor, bias_h: torch.Tensor,
                   window_mask: Optional[torch.Tensor] = None,
                   softmax_dtype: torch.dtype = torch.float32
                   ) -> torch.Tensor:
    """SwinV2 cosine window attention through
    ``csrc/swin_attention_fwd.cu`` (see ``swin_attention_plain``).
    ``logit_scale`` (H,), ``bias_h`` and ``window_mask`` must be fp32 on the
    card."""
    if softmax_dtype != torch.float32:
        raise NotImplementedError(
            "a bf16 softmax chain in the Swin attention kernel is not "
            "ported yet; use swin_softmax_dtype='float32'")
    if q.device.type == "cpu":
        return swin_attention_plain(q, k, v, logit_scale, bias_h,
                                    window_mask, softmax_dtype)
    Bn, H, N, D = q.shape
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
            torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on_error(err, "swin_attention_fwd")
    swin_attention.launches += 1
    return out


swin_attention.launches = 0


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
