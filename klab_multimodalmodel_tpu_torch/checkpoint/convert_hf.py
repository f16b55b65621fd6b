"""HuggingFace state dicts -> the port's per-tower state dicts.

The port's modules carry HF's parameter names, so a conversion is mostly a
check: every tensor the tower holds is in the checkpoint with the shape its
geometry (``T5Size`` / ``SwinV2Size``) gives it, nothing else of the tower
is left over, and every tensor comes out in fp32. A mismatch raises
``ValueError`` naming the tensors. Left out, as ``from_jax.py`` leaves them
out: the tied copies (``encoder.embed_tokens``, ``decoder.embed_tokens``, a
tied ``lm_head``); the SwinV2 tables the port recomputes
(``relative_coords_table``, ``relative_position_index``); and an image
classifier's head (``classifier``, ``pooler``), after the ``swinv2.`` prefix
of ``Swinv2ForImageClassification`` is stripped.

The port's copy of the JAX package's ``checkpoint/convert_hf.py`` and of
its HF conversion command's assembly (``convert_hf_checkpoint`` below).
"""

from __future__ import annotations

from typing import Callable, Mapping

import numpy as np
import torch

from ..config import Config, SwinV2Size, T5Size

TIED_EMBEDDINGS = ("encoder.embed_tokens.weight",
                   "decoder.embed_tokens.weight")
SWIN_TABLES = ("relative_coords_table", "relative_position_index")


def _gated(size: T5Size) -> bool:
    return size.feed_forward_proj.startswith("gated-")


def expected_shapes(module: torch.nn.Module) -> dict[str, tuple]:
    return {k: tuple(v.shape) for k, v in module.state_dict().items()}


def take(sd: Mapping[str, torch.Tensor], expected: dict[str, tuple],
         what: str, skip: Callable[[str], bool]) -> dict[str, torch.Tensor]:
    """The ``expected`` tensors of ``sd`` in fp32. Raises ``ValueError``
    where one is missing or has another shape, or where ``sd`` holds a key
    that is neither expected nor ``skip``ped."""
    missing = sorted(k for k in expected if k not in sd)
    wrong = [f"{k} {tuple(sd[k].shape)} (expected {shape})"
             for k, shape in expected.items()
             if k in sd and tuple(sd[k].shape) != shape]
    extra = sorted(k for k in sd if k not in expected and not skip(k))
    if missing or wrong or extra:
        parts = [f"{len(v)} {name}: {', '.join(v[:5])}"
                 + (", ..." if len(v) > 5 else "")
                 for name, v in (("missing", missing), ("of another shape",
                                 wrong), ("unexpected", extra)) if v]
        raise ValueError(f"{what}: the checkpoint does not match the "
                         "geometry: " + "; ".join(parts))
    return {k: sd[k].detach().to(torch.float32).contiguous()
            for k in expected}


def _check_mlp(sd: Mapping[str, torch.Tensor], size: T5Size,
               what: str) -> None:
    gated = any(".DenseReluDense.wi_0." in k for k in sd)
    if gated != _gated(size):
        raise ValueError(
            f"{what}: the checkpoint's MLPs are "
            f"{'gated (v1.1)' if gated else 'un-gated'}, the geometry's "
            f"feed_forward_proj is {size.feed_forward_proj!r}")


def convert_t5_lm(sd: Mapping[str, torch.Tensor], size: T5Size
                  ) -> dict[str, torch.Tensor]:
    """HF ``T5ForConditionalGeneration`` state dict -> the port's."""
    from ..models.t5 import T5ForConditionalGeneration

    _check_mlp(sd, size, "T5 LM")
    tied = size.tie_word_embeddings
    return take(sd, expected_shapes(T5ForConditionalGeneration(
        size, device="meta")), "T5 LM",
        lambda k: k in TIED_EMBEDDINGS or (tied and k == "lm_head.weight"))


def convert_t5_encoder(sd: Mapping[str, torch.Tensor], size: T5Size
                       ) -> dict[str, torch.Tensor]:
    """The encoder of a HF ``T5EncoderModel`` or
    ``T5ForConditionalGeneration`` state dict -> the port's ``T5Encoder``."""
    from ..models.t5 import T5Encoder

    _check_mlp(sd, size, "T5 encoder")
    return take(sd, expected_shapes(T5Encoder(size, device="meta")),
                "T5 encoder",
                lambda k: (k in TIED_EMBEDDINGS or k == "lm_head.weight"
                           or k.startswith("decoder.")))


def convert_swinv2(sd: Mapping[str, torch.Tensor], size: SwinV2Size
                   ) -> dict[str, torch.Tensor]:
    """HF ``Swinv2Model`` (or ``Swinv2ForImageClassification``) state
    dict -> the port's ``SwinV2Encoder``."""
    from ..models.swinv2 import SwinV2Encoder

    sd = {k.removeprefix("swinv2."): v for k, v in sd.items()}
    return take(sd, expected_shapes(SwinV2Encoder(size, device="meta")),
                "SwinV2",
                lambda k: (k.rsplit(".", 1)[-1] in SWIN_TABLES
                           or k.startswith(("classifier.", "pooler."))))


def vision_projection(config: Config) -> torch.Tensor | None:
    """The projection's weight (out, in) for freshly converted towers: the
    identity where the widths agree, else ``np.random.default_rng(0)``'s
    draw scaled by 1/sqrt(in), as the JAX package's conversion makes it.
    None where the model has no projection."""
    d_model = config.transformer_t5.d_model
    vis = config.swin.num_features
    if not (config.use_vision_projection or vis != d_model):
        return None
    if vis == d_model:
        return torch.eye(d_model, dtype=torch.float32)
    rng = np.random.default_rng(0)
    kernel = (rng.standard_normal((vis, d_model)) / np.sqrt(vis)).astype(
        np.float32)
    return torch.from_numpy(np.ascontiguousarray(kernel.T))


def convert_hf_checkpoint(t5_sd: Mapping[str, torch.Tensor],
                          swin_sd: Mapping[str, torch.Tensor],
                          config: Config) -> dict[str, torch.Tensor]:
    """One HF T5 checkpoint (both the text tower and the transformer) and
    one SwinV2 checkpoint -> a state dict of the port's ``MultiModalModel``
    towers and vision projection, for ``save_pretrained``."""
    out: dict[str, torch.Tensor] = {}
    for prefix, part in (
            ("image_model", convert_swinv2(swin_sd, config.swin)),
            ("language_model", convert_t5_encoder(t5_sd,
                                                  config.language_t5)),
            ("transformer", convert_t5_lm(t5_sd, config.transformer_t5))):
        out.update({f"{prefix}.{k}": v for k, v in part.items()})
    proj = vision_projection(config)
    if proj is not None:
        out["vision_projection.weight"] = proj
    return out
