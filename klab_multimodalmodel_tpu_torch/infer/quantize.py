"""Int8 weight-only quantization for the decode path.

The port of the JAX package's ``infer/quantize.py``. Decode at serving batch
sizes streams every dense weight once per pass; int8 weights quarter the
fp32 bytes held for decode while activations, accumulation and every other
op stay in the model's compute dtype.

* Per-output-channel symmetric scales: ``W ≈ Q * s[:, None]`` over the
  port's (out, in) weight layout, with ``Q`` int8 and ``s = absmax(W, in) /
  127``. The quantizer is numpy, as the JAX package's is, so ``Q`` and ``s``
  equal the JAX package's bitwise after the transpose.
* Every T5 product is bias-free, so ``x (Q s)^T == (x Q^T) s``:
  ``models.t5.KlabDense`` multiplies its output by the ``qscale`` buffer in
  fp32 and casts back, as the JAX ``KlabDense`` applies its ``qscale``
  collection.
* ``int8_head=True`` also gives the tied LM head an int8 copy of the
  embedding and a per-vocab-row scale (the ``head_q`` / ``head_scale``
  buffers that ``T5ForConditionalGeneration._lm_logits`` reads); the
  embedding itself stays for the lookup. Off by default, as in the JAX
  package.
* ``cast_for_decode`` casts every remaining fp32 parameter (embedding,
  norms, relative-position tables) to bf16. The module's compute dtype stays
  fp32, so those values are used as bf16-rounded fp32, as flax's
  ``promote_dtype`` uses them in the JAX package.

The int8 product dequantizes ``Q`` to the compute dtype per call
(``F.linear(x, Q.to(dt))``): the JAX package's is an XLA dot with a convert,
no kernel of its own.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.t5 import KlabDense, T5ForConditionalGeneration


def quantize_kernel(weight: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(int8 Q, per-output-channel scale) for a (..., out, in) weight:
    a symmetric absmax grid over the contraction (in) axis. All-zero rows
    get scale 1 (Q is zero there anyway)."""
    w = np.asarray(weight, np.float32)
    absmax = np.max(np.abs(w), axis=-1, keepdims=True)
    scale = np.where(absmax > 0, absmax / np.float32(127.0),
                     np.float32(1.0)).astype(np.float32)
    q = np.clip(np.rint(w / scale), -127, 127).astype(np.int8)
    return q, scale.squeeze(-1)


def dequantize_kernel(q: np.ndarray, scale: np.ndarray) -> np.ndarray:
    """Inverse of :func:`quantize_kernel` (tests and export)."""
    return (np.asarray(q, np.float32)
            * np.expand_dims(np.asarray(scale, np.float32), -1))


def cast_for_decode(model: torch.nn.Module,
                    dtype: torch.dtype = torch.bfloat16) -> torch.nn.Module:
    """Cast every fp32 parameter of ``model`` to ``dtype``, in place (each
    gets a new storage; one it shared is left as it was)."""
    with torch.no_grad():
        for p in model.parameters():
            if p.dtype == torch.float32:
                p.data = p.data.to(dtype)
    return model


def quantize_for_decode(model: T5ForConditionalGeneration,
                        cast_dtype=torch.bfloat16,
                        int8_head: bool = False
                        ) -> T5ForConditionalGeneration:
    """A decode-only copy of ``model`` (left untouched) on its device: each
    ``KlabDense`` weight (q, k, v, o, wi, wi_0, wi_1, wo, an untied
    lm_head) replaced by its int8 grid with a ``qscale`` buffer, every
    other fp32 parameter cast to ``cast_dtype`` (None keeps fp32), compute
    in fp32. An MoE model's router and expert banks are no ``KlabDense``:
    they are cast, not quantized, as the JAX package's
    ``QUANT_KERNEL_MODULES`` leaves them. With ``int8_head`` a tied head
    gets ``head_q`` and ``head_scale`` too."""
    out = T5ForConditionalGeneration(
        model.size, use_pallas=model.encoder.use_pallas,
        dtype=torch.float32, device="meta",
        **model.moe_kwargs).requires_grad_(False)
    state = {}
    for name, p in model.named_parameters():
        state[name] = p.detach()
    qscales = {}
    for name, mod in model.named_modules():
        if isinstance(mod, KlabDense):
            q, s = quantize_kernel(mod.weight.detach().float().cpu().numpy())
            dev = mod.weight.device
            state[f"{name}.weight"] = torch.from_numpy(q).to(dev)
            qscales[name] = torch.from_numpy(s).to(dev)
    # The copy shares the original's fp32 storages until the cast below
    # replaces them: decode never writes a weight.
    out.load_state_dict(state, strict=True, assign=True)
    if cast_dtype is not None:
        cast_for_decode(out, cast_dtype)
    for name, s in qscales.items():
        out.get_submodule(name).qscale = s
    if int8_head and model.size.tie_word_embeddings:
        emb = model.shared.weight.detach().float().cpu().numpy()  # (V, d)
        q, s = quantize_kernel(emb)  # scale over d, per vocab row
        dev = model.shared.weight.device
        out.head_q = torch.from_numpy(q).to(dev)
        out.head_scale = torch.from_numpy(s).to(dev)
    return out.eval()


def decode_bytes(model: torch.nn.Module) -> int:
    """Bytes of a module's parameters and buffers."""
    return sum(t.numel() * t.element_size()
               for t in list(model.parameters()) + list(model.buffers()))
