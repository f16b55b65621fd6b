"""The multimodal captioning model.

A SwinV2 image encoder and a frozen T5 text encoder produce embeddings that
are projected, concatenated along the sequence axis and fed as
``inputs_embeds`` into a full T5 encoder-decoder: image+text embeddings act
as soft prompts re-encoded by the main T5's own encoder.

Both towers run deterministically (no dropout or drop-path, as in the JAX
package, even when the image tower trains). The text tower is always frozen
and runs under ``torch.no_grad()`` (the JAX package's ``stop_gradient``), so
autograd keeps no graph for it. The image tower runs under autograd when it
trains (``image_model_train`` without ``freeze_image_model_updates``), its
window attention through the Swin kernel's recompute backward when the
kernel flag is on; otherwise it runs under ``torch.no_grad()`` too. (With
``freeze_image_model_updates`` the JAX package computes the tower's
gradients and drops them; skipping them gives the same update.)
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..config import Config
from ..utils.device import resolve_device
from .layers import Dense, lecun_normal_
from .swinv2 import SwinV2Encoder
from .t5 import Cache, Seq2SeqOutput, T5Encoder, T5ForConditionalGeneration


class MultiModalModel(nn.Module):
    """SwinV2 + frozen T5 encoder -> seq-concat -> T5 enc-dec.

    ``dtype``: the compute dtype (fp32 for captioning, the policy's for
    training); parameters are fp32 (the trainer may store the frozen towers'
    in bf16). ``device``: None means the card (see
    ``utils.device``). Weights are uninitialized until ``init_weights`` or
    ``load_state_dict``.
    """

    def __init__(self, config: Config, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        cfg = self.config = config
        self.dtype = dtype
        sm = (torch.bfloat16 if cfg.swin_softmax_dtype == "bfloat16"
              else torch.float32)
        with torch.device(device):
            self.image_model = SwinV2Encoder(
                cfg.swin, use_pallas=cfg.use_pallas_attention,
                softmax_dtype=sm, gelu_approximate=cfg.swin_gelu_approximate,
                dtype=dtype, device=device)
            self.language_model = T5Encoder(
                cfg.language_t5, use_pallas=cfg.use_pallas_t5_attention,
                dtype=dtype, device=device)
            self.transformer = T5ForConditionalGeneration(
                cfg.transformer_t5, use_pallas=cfg.use_pallas_t5_attention,
                dtype=dtype, remat=cfg.remat, device=device)
            d_model = cfg.transformer_t5.d_model
            vis_dim = cfg.swin.num_features
            if cfg.use_vision_projection or vis_dim != d_model:
                self.vision_projection = Dense(vis_dim, d_model, bias=False,
                                               compute_dtype=dtype)
            lang_dim = cfg.language_t5.d_model
            if lang_dim != d_model:
                self.language_projection = Dense(lang_dim, d_model,
                                                 bias=False,
                                                 compute_dtype=dtype)

    def init_weights(self, generator: torch.Generator) -> None:
        """Seeded random weights with the JAX init's distributions; the
        vision projection starts as the identity when it is square."""
        self.image_model.init_weights(generator)
        self.language_model.init_weights(generator)
        self.transformer.init_weights(generator)
        proj = getattr(self, "vision_projection", None)
        if proj is not None:
            if proj.in_features == proj.out_features:
                with torch.no_grad():
                    proj.weight.copy_(torch.eye(proj.in_features))
            else:
                lecun_normal_(proj.weight, proj.in_features, generator)
        if hasattr(self, "language_projection"):
            lecun_normal_(self.language_projection.weight,
                          self.language_projection.in_features, generator)

    # -- frozen towers ------------------------------------------------------
    def image_features(self, images: torch.Tensor) -> torch.Tensor:
        """Frozen vision-tower forward, before the projection: the cacheable
        part."""
        with torch.no_grad():
            return self.image_model(images)

    def language_features(self, source_ids: torch.Tensor,
                          source_mask: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
        """Frozen text-tower forward, before the projection."""
        if self.config.reference_pad_quirks:
            source_mask = None
        return self._language(source_ids, source_mask)

    def _language(self, source_ids, source_mask) -> torch.Tensor:
        with torch.no_grad():
            return self.language_model(input_ids=source_ids,
                                       attention_mask=source_mask)

    # -- embedding cascade -------------------------------------------------
    def encode_multimodal(self, images: torch.Tensor, source_ids: torch.Tensor,
                          source_mask: Optional[torch.Tensor] = None
                          ) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
        """images (B,H,W,3) + token ids -> (concat_embeds, concat_mask)."""
        lang = self._language(source_ids, source_mask)
        cfg = self.config
        if cfg.image_model_train and not cfg.freeze_image_model_updates:
            img = self.image_model(images)
        else:
            img = self.image_features(images)
        return self._project_and_concat(img, lang, source_mask)

    def _project_and_concat(self, img: torch.Tensor, lang: torch.Tensor,
                            source_mask: Optional[torch.Tensor]
                            ) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
        if hasattr(self, "vision_projection"):
            img = self.vision_projection(img)
        if hasattr(self, "language_projection"):
            lang = self.language_projection(lang)
        concat = torch.cat([img, lang], dim=1)
        if source_mask is None:
            return concat, None
        # Image tokens are valid wherever the ROW is: a row whose source is
        # entirely padding is masked wholesale, image tokens included.
        row_valid = source_mask.amax(dim=1, keepdim=True)
        img_mask = row_valid.expand(-1, img.shape[1])
        return concat, torch.cat([img_mask, source_mask], dim=1)

    # -- training forward --------------------------------------------------
    def forward(self, images: torch.Tensor, source_ids: torch.Tensor,
                target_ids: torch.Tensor,
                source_mask: Optional[torch.Tensor] = None,
                target_mask: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None
                ) -> Seq2SeqOutput:
        """Loss of captioning ``target_ids`` from images + prompt ids; pad
        targets (``target_mask`` 0) are left out of the loss."""
        if self.config.reference_pad_quirks:
            # Bit-parity mode: no attention masks anywhere, pads in the loss.
            source_mask = None
            target_mask = None
        concat, concat_mask = self.encode_multimodal(images, source_ids,
                                                     source_mask)
        return self._transformer_loss(concat, concat_mask, target_ids,
                                      target_mask, deterministic, generator)

    def loss_from_image_features(
            self, image_features: torch.Tensor, source_ids: torch.Tensor,
            target_ids: torch.Tensor,
            source_mask: Optional[torch.Tensor] = None,
            target_mask: Optional[torch.Tensor] = None,
            language_features: Optional[torch.Tensor] = None,
            deterministic: bool = True,
            generator: Optional[torch.Generator] = None) -> Seq2SeqOutput:
        """Training forward from cached tower features: the same loss as
        ``forward`` when ``image_features == image_features(images)``.
        ``language_features``, when given, replaces the text-tower
        forward."""
        if self.config.reference_pad_quirks:
            source_mask = None
            target_mask = None
        if language_features is None:
            lang = self._language(source_ids, source_mask)
        else:
            lang = language_features.to(self.dtype)
        concat, concat_mask = self._project_and_concat(
            image_features.to(self.dtype), lang, source_mask)
        return self._transformer_loss(concat, concat_mask, target_ids,
                                      target_mask, deterministic, generator)

    def _transformer_loss(self, concat, concat_mask, target_ids, target_mask,
                          deterministic, generator) -> Seq2SeqOutput:
        label_weights = None
        if target_mask is not None:
            label_weights = target_mask.to(torch.float32)
        return self.transformer(
            inputs_embeds=concat, attention_mask=concat_mask,
            labels=target_ids, label_weights=label_weights,
            decoder_attention_mask=self._decoder_mask(target_mask),
            deterministic=deterministic, generator=generator)

    def _decoder_mask(self, target_mask):
        """Decoder key mask: none for the dense model (target pads trail the
        sequence, so the causal mask already hides them and the loss weights
        drop their rows). The JAX package passes it only to route MoE
        tokens, which the port does not have."""
        if self.config.moe_experts > 0:
            return target_mask
        return None

    # -- generation entry (encoder half; the decode loop lives in infer/) --
    def encode_for_generation(self, images: torch.Tensor,
                              source_ids: torch.Tensor,
                              source_mask: Optional[torch.Tensor] = None
                              ) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
        if self.config.reference_pad_quirks:
            # The reference attends pads during generation too.
            source_mask = None
        concat, concat_mask = self.encode_multimodal(images, source_ids,
                                                     source_mask)
        enc = self.transformer.encode(inputs_embeds=concat,
                                      attention_mask=concat_mask)
        return enc, concat_mask

    def decode_step(self, token: torch.Tensor, step: int,
                    encoder_hidden: torch.Tensor, max_decode_len: int,
                    encoder_mask: Optional[torch.Tensor] = None,
                    cache: Optional[Cache] = None
                    ) -> tuple[torch.Tensor, Cache]:
        return self.transformer.decode_step(
            token, step, encoder_hidden, max_decode_len,
            encoder_attention_mask=encoder_mask, cache=cache)
