"""JAX parameter tree -> the port's ``MultiModalModel`` state dict.

Takes the JAX package's parameters as nested dicts of numpy arrays (what
``jax.tree.map(np.asarray, params)`` gives), so this module needs no JAX.
Layout rules (the port's own copy of the JAX package's HF export rules):

* flax Dense kernels (in, out) -> torch Linear weights (out, in);
* scanned T5 stacks carry a leading layer axis that unstacks into
  per-layer keys;
* flax conv kernels (kh, kw, in, out) -> torch (out, in, kh, kw);
* keys are HF's names, as the port's modules use them. Tied copies
  (``embed_tokens``, a tied ``lm_head``) are not emitted;
* an MoE block's ``mlp/router`` kernel (D, E) becomes the port's
  ``…layer.{ff}.mlp.router.weight`` (E, D), and its ``mlp/experts_wi``
  (E, D, F) and ``mlp/experts_wo`` (E, F, D) become
  ``…layer.{ff}.mlp.experts_wi`` / ``.experts_wo`` unchanged. No HF T5
  checkpoint has experts: the names keep HF's prefix up to the feed-forward
  layer;
* a pipelined stack (``pipeline/stages/block/block/…``, leaves of shape
  (S, L / S, …)) is read through ``unpipeline_t5_params`` as the scanned
  stack it reshapes to: the port's layers are one list whatever the stage
  count.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from ..config import Config, SwinV2Size, T5Size

Params = Mapping[str, Any]


def _np(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def _t(w) -> np.ndarray:
    return _np(w).T


def unpipeline_t5_params(params: Params) -> dict:
    """The JAX package's ``unpipeline_t5_params`` on numpy trees: each
    pipelined stack's (S, L / S, …) leaves reshaped to the scanned
    ``layers/block`` layout's (L, …); other trees are returned as they
    are."""
    p = dict(params)
    for key in ("encoder", "decoder"):
        if key in p and "pipeline" in p[key]:
            stack = {k: v for k, v in p[key].items() if k != "pipeline"}
            stack["layers"] = {"block": _map(
                lambda a: a.reshape((a.shape[0] * a.shape[1],)
                                    + a.shape[2:]),
                p[key]["pipeline"]["stages"]["block"]["block"])}
            p[key] = stack
    return p


def _map(fn, tree):
    if isinstance(tree, Mapping):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(np.asarray(tree))


def _t5_stack(stack: Params, relpos: Params, prefix: str, num_layers: int,
              is_decoder: bool, out: dict) -> None:
    block = stack["layers"]["block"]
    ff_idx = 2 if is_decoder else 1
    for i in range(num_layers):
        b = f"{prefix}.block.{i}.layer"
        out[f"{b}.0.layer_norm.weight"] = _np(block["ln_self"]["weight"][i])
        for p in ("q", "k", "v", "o"):
            out[f"{b}.0.SelfAttention.{p}.weight"] = _t(
                block["SelfAttention"][p]["kernel"][i])
        if is_decoder:
            out[f"{b}.1.layer_norm.weight"] = _np(
                block["ln_cross"]["weight"][i])
            for p in ("q", "k", "v", "o"):
                out[f"{b}.1.EncDecAttention.{p}.weight"] = _t(
                    block["EncDecAttention"][p]["kernel"][i])
        out[f"{b}.{ff_idx}.layer_norm.weight"] = _np(
            block["ln_mlp"]["weight"][i])
        mlp = block["mlp"]
        if "experts_wi" in mlp:
            f = f"{b}.{ff_idx}.mlp"
            out[f"{f}.router.weight"] = _t(mlp["router"]["kernel"][i])
            out[f"{f}.experts_wi"] = _np(mlp["experts_wi"][i])
            out[f"{f}.experts_wo"] = _np(mlp["experts_wo"][i])
            continue
        # v1.1 gated MLPs carry wi_0/wi_1 instead of wi.
        for p in sorted(mlp):
            out[f"{b}.{ff_idx}.DenseReluDense.{p}.weight"] = _t(
                mlp[p]["kernel"][i])
    out[f"{prefix}.block.0.layer.0.SelfAttention.relative_attention_bias"
        ".weight"] = _np(relpos["embedding"])
    out[f"{prefix}.final_layer_norm.weight"] = _np(
        stack["final_layer_norm"]["weight"])


def convert_t5_lm(params: Params, size: T5Size) -> dict:
    """JAX ``T5ForConditionalGeneration`` params (scanned or pipelined,
    dense or MoE) -> port state dict (numpy)."""
    params = unpipeline_t5_params(params)
    sd: dict = {"shared.weight": _np(params["shared"]["embedding"])}
    _t5_stack(params["encoder"], params["enc_relpos_bias"], "encoder",
              size.num_layers, False, sd)
    _t5_stack(params["decoder"], params["dec_relpos_bias"], "decoder",
              size.num_decoder_layers, True, sd)
    if not size.tie_word_embeddings:
        sd["lm_head.weight"] = _t(params["lm_head"]["kernel"])
    return sd


def convert_t5_encoder(params: Params, size: T5Size) -> dict:
    """JAX ``T5Encoder`` params -> port state dict (numpy)."""
    sd: dict = {"shared.weight": _np(params["shared"]["embedding"])}
    _t5_stack(params["encoder"], params["relpos_bias"], "encoder",
              size.num_layers, False, sd)
    return sd


def convert_swinv2(params: Params, size: SwinV2Size) -> dict:
    """JAX ``SwinV2Encoder`` params -> port state dict (numpy)."""
    sd: dict = {
        "embeddings.patch_embeddings.projection.weight": _np(
            params["patch_embed_proj"]["kernel"]).transpose(3, 2, 0, 1),
        "embeddings.patch_embeddings.projection.bias": _np(
            params["patch_embed_proj"]["bias"]),
        "embeddings.norm.weight": _np(params["patch_embed_norm"]["weight"]),
        "embeddings.norm.bias": _np(params["patch_embed_norm"]["bias"]),
        "layernorm.weight": _np(params["final_norm"]["weight"]),
        "layernorm.bias": _np(params["final_norm"]["bias"]),
    }
    for si, depth in enumerate(size.depths):
        for li in range(depth):
            blk = params[f"stage_{si}_block_{li}"]
            attn = blk["attn"]
            pre = f"encoder.layers.{si}.blocks.{li}."
            a = pre + "attention.self."
            sd[a + "logit_scale"] = _np(attn["logit_scale"]).reshape(-1, 1, 1)
            sd[a + "continuous_position_bias_mlp.0.weight"] = _t(
                attn["cpb_fc1"]["kernel"])
            sd[a + "continuous_position_bias_mlp.0.bias"] = _np(
                attn["cpb_fc1"]["bias"])
            sd[a + "continuous_position_bias_mlp.2.weight"] = _t(
                attn["cpb_fc2"]["kernel"])
            sd[a + "query.weight"] = _t(attn["q"]["kernel"])
            sd[a + "query.bias"] = _np(attn["q"]["bias"])
            sd[a + "key.weight"] = _t(attn["k"]["kernel"])
            sd[a + "value.weight"] = _t(attn["v"]["kernel"])
            sd[a + "value.bias"] = _np(attn["v"]["bias"])
            sd[pre + "attention.output.dense.weight"] = _t(
                attn["proj"]["kernel"])
            sd[pre + "attention.output.dense.bias"] = _np(
                attn["proj"]["bias"])
            sd[pre + "layernorm_before.weight"] = _np(blk["norm1"]["weight"])
            sd[pre + "layernorm_before.bias"] = _np(blk["norm1"]["bias"])
            sd[pre + "layernorm_after.weight"] = _np(blk["norm2"]["weight"])
            sd[pre + "layernorm_after.bias"] = _np(blk["norm2"]["bias"])
            sd[pre + "intermediate.dense.weight"] = _t(
                blk["mlp"]["fc1"]["kernel"])
            sd[pre + "intermediate.dense.bias"] = _np(
                blk["mlp"]["fc1"]["bias"])
            sd[pre + "output.dense.weight"] = _t(blk["mlp"]["fc2"]["kernel"])
            sd[pre + "output.dense.bias"] = _np(blk["mlp"]["fc2"]["bias"])
        if si < len(size.depths) - 1:
            ds = params[f"stage_{si}_downsample"]
            dpre = f"encoder.layers.{si}.downsample."
            sd[dpre + "reduction.weight"] = _t(ds["reduction"]["kernel"])
            sd[dpre + "norm.weight"] = _np(ds["norm"]["weight"])
            sd[dpre + "norm.bias"] = _np(ds["norm"]["bias"])
    return sd


def convert_jax_params(params: Params, config: Config
                       ) -> dict[str, torch.Tensor]:
    """JAX ``MultiModalModel`` params (nested dicts of numpy arrays) -> a
    state dict that ``MultiModalModel(config).load_state_dict(...,
    strict=True)`` takes (CPU fp32 tensors)."""
    sd: dict = {}
    parts = (("image_model", convert_swinv2(params["image_model"],
                                            config.swin)),
             ("language_model", convert_t5_encoder(params["language_model"],
                                                   config.language_t5)),
             ("transformer", convert_t5_lm(params["transformer"],
                                           config.transformer_t5)))
    for prefix, part in parts:
        sd.update({f"{prefix}.{k}": v for k, v in part.items()})
    for name in ("vision_projection", "language_projection"):
        if name in params:
            sd[f"{name}.weight"] = _t(params[name]["kernel"])
    return {k: torch.tensor(v) for k, v in sd.items()}
