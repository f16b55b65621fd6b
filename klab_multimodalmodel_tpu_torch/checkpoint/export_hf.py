"""The port's per-tower state dicts -> HuggingFace state dicts (the inverse
of ``convert_hf.py``).

Each tower is checked against its geometry as ``convert_hf`` checks it, cast
to fp32, and given back the tied copies HF's modules hold, so that
``transformers``' ``T5ForConditionalGeneration``, ``T5EncoderModel`` and
``Swinv2Model`` take the result with ``load_state_dict(strict=True)``. The
port's copy of the JAX package's ``checkpoint/export_hf.py``. An MoE
transformer has no HF T5 layout: ``export_t5_lm`` raises ``ValueError``
for one (the JAX exporter fails on its expert leaves too, less clearly).
"""

from __future__ import annotations

from typing import Mapping

import torch

from ..config import SwinV2Size, T5Size
from .convert_hf import TIED_EMBEDDINGS, expected_shapes, take


def _never(key: str) -> bool:
    return False


def split_towers(state: Mapping[str, torch.Tensor]
                 ) -> dict[str, dict[str, torch.Tensor]]:
    """A whole model's state dict -> one state dict per top-level submodule
    (``transformer``, ``language_model``, ``image_model``,
    ``vision_projection``), keys without the prefix."""
    out: dict[str, dict[str, torch.Tensor]] = {}
    for key, value in state.items():
        top, _, rest = key.partition(".")
        out.setdefault(top, {})[rest] = value
    return out


def export_t5_lm(sd: Mapping[str, torch.Tensor], size: T5Size
                 ) -> dict[str, torch.Tensor]:
    """The port's ``T5ForConditionalGeneration`` -> HF's."""
    from ..models.t5 import T5ForConditionalGeneration

    if any(".mlp.experts_" in k for k in sd):
        raise ValueError(
            "an MoE transformer (moe_experts > 0) has no HuggingFace T5 "
            "layout: HF's T5 has one dense MLP per block, not expert banks "
            "and a router; export the dense model")

    out = take(sd, expected_shapes(T5ForConditionalGeneration(
        size, device="meta")), "T5 LM", _never)
    for key in TIED_EMBEDDINGS:
        out[key] = out["shared.weight"]
    if size.tie_word_embeddings:
        out["lm_head.weight"] = out["shared.weight"]
    return out


def export_t5_encoder(sd: Mapping[str, torch.Tensor], size: T5Size
                      ) -> dict[str, torch.Tensor]:
    """The port's ``T5Encoder`` -> HF's ``T5EncoderModel``."""
    from ..models.t5 import T5Encoder

    out = take(sd, expected_shapes(T5Encoder(size, device="meta")),
               "T5 encoder", _never)
    out["encoder.embed_tokens.weight"] = out["shared.weight"]
    return out


def export_swinv2(sd: Mapping[str, torch.Tensor], size: SwinV2Size
                  ) -> dict[str, torch.Tensor]:
    """The port's ``SwinV2Encoder`` -> HF's ``Swinv2Model``."""
    from ..models.swinv2 import SwinV2Encoder

    return take(sd, expected_shapes(SwinV2Encoder(size, device="meta")),
                "SwinV2", _never)
