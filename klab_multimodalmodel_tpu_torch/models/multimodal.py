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

Under sequence parallelism (``set_seq_group``) the three T5 stacks split
their positions over the seq group (``models/t5.py``); the SwinV2 tower and
the concatenation run whole on every rank, as the JAX package leaves them
unconstrained, and the text tower's output is gathered whole before it, so
the transformer's encoder takes its rows of the concatenation (the image
tokens lead: seq rank 0's rows hold them). Beside ``tensor`` the frozen
text tower stays whole on every tensor rank (``parallel/partitioning.py``)
but still splits its positions over ``seq``: its attention runs every head
(``head_offset`` 0) at its rank's query rows (``q_offset``), while the
transformer's runs its tensor rank's heads at those rows, both offsets at
once.

Under the ``pipe`` and ``expert`` axes only the transformer splits (its
stages or its experts: ``T5ForConditionalGeneration.split_stages`` /
``split_experts``); the towers and the projections stay whole on every
rank, as the JAX package leaves them unpipelined.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
from torch import nn

from ..config import Config
from ..parallel.partitioning import gather_columns
from ..utils.device import resolve_device
from .layers import Dense, Init, Plan, PlanInit, sub_plan
from .swinv2 import SwinV2Encoder
from .t5 import Cache, Seq2SeqOutput, T5Encoder, T5ForConditionalGeneration


class MultiModalModel(PlanInit, nn.Module):
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
                dtype=dtype, remat=cfg.remat, device=device,
                pipeline_stages=cfg.pipeline_stages,
                pipeline_microbatches=cfg.pipeline_microbatches,
                moe_experts=cfg.moe_experts, moe_top_k=cfg.moe_top_k,
                moe_capacity_factor=cfg.moe_capacity_factor,
                moe_aux_loss_weight=cfg.moe_aux_loss_weight)
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

    def init_plan(self) -> Plan:
        """Seeded random weights with the JAX init's distributions
        (``init_weights`` runs this plan); the vision projection starts as
        the identity when it is square."""
        for name in ("image_model", "language_model", "transformer"):
            yield from sub_plan(name, getattr(self, name).init_plan())
        proj = getattr(self, "vision_projection", None)
        if proj is not None:
            yield "vision_projection.weight", (
                Init("eye") if proj.in_features == proj.out_features
                else Init("lecun_normal", proj.in_features))
        if hasattr(self, "language_projection"):
            yield "language_projection.weight", Init(
                "lecun_normal", self.language_projection.in_features)

    def reset_buffers(self) -> None:
        """The static tables that the state dict does not hold (the Swin
        tower's), rebuilt on the parameters' device: after a build on the
        meta device and ``to_empty``, they hold garbage."""
        self.image_model.reset_buffers()

    def set_seq_group(self, seq_group, mesh) -> None:
        """Split the T5 stacks' full-sequence forwards over ``seq_group``
        (a ``parallel.partitioning.SeqGroup`` of ``mesh``), with the
        config's ``seq_attention``."""
        ring = self.config.seq_attention == "ring"
        for stack in (self.language_model.encoder, self.transformer.encoder,
                      self.transformer.decoder):
            stack.set_seq_group(seq_group, mesh, ring)

    @contextlib.contextmanager
    def computing_in(self, dtype: torch.dtype):
        """Run the block with every submodule's compute dtype set to
        ``dtype``, the parameters untouched, and the dtypes put back after:
        the training loop's caption evaluation computes in fp32 on the
        trainer's own model (a ``Captioner``'s compute dtype), as the JAX
        package's evaluation runs an fp32 model on the training
        parameters."""
        saved = [(m, name, getattr(m, name)) for m in self.modules()
                 for name in ("dtype", "compute_dtype")
                 if isinstance(getattr(m, name, None), torch.dtype)]
        for m, name, _ in saved:
            setattr(m, name, dtype)
        try:
            yield self
        finally:
            for m, name, value in saved:
                setattr(m, name, value)

    @contextlib.contextmanager
    def unpipelined(self):
        """Run the block with the transformer's GPipe schedule off (one
        stage, the same layers): decoding is a sequential cache loop with
        nothing to pipeline, as the JAX package's ``Captioner`` decodes a
        pipelined model through its unpipelined parameters."""
        stacks = (self.transformer.encoder, self.transformer.decoder)
        saved = [s.pipeline_stages for s in stacks]
        for s in stacks:
            s.pipeline_stages = 1
        try:
            yield self
        finally:
            for s, stages in zip(stacks, saved):
                s.pipeline_stages = stages

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
        # Under tensor parallelism the projections are column-parallel:
        # their outputs are gathered (``gather_columns``).
        if hasattr(self, "vision_projection"):
            img = gather_columns(self.vision_projection(img),
                                 self.vision_projection.weight)
        if hasattr(self, "language_projection"):
            lang = gather_columns(self.language_projection(lang),
                                  self.language_projection.weight)
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
        """Decoder key mask, passed only under MoE: it is the decoder's
        routing mask, so pad targets claim no expert capacity and stay out
        of the balance loss (and phantom rows of the accumulation tail, all
        of whose targets are masked, route nowhere). It changes no loss of
        the attention itself: target pads trail the sequence, so the causal
        mask already hides them from real queries, and the loss weights
        drop their rows. The dense model passes none, as the JAX package's
        does."""
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
