"""End-to-end captioning: uint8 images + prompt -> decoded strings."""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Iterator, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from ..config import Config
from ..data.datasets import COCO_PROMPT
from ..data.image_ops import normalize_images
from ..models.multimodal import MultiModalModel
from ..text.tokenizer import TokenizerBase
from ..utils.bucketing import pow2_bucket_width
from ..utils.device import resolve_device
from .generate import generate, stream_decode


class Captioner:
    """Batched caption generation (greedy, beam search, sampling,
    streaming), in fp32.

    ``state_dict_or_model``: a ``MultiModalModel`` state dict (loaded with
    ``strict=True`` into a model built here), or a ``MultiModalModel``
    already on ``device``, such as a trainer's. A model built with another
    compute dtype computes in fp32 for the length of each call and is put
    back after; its parameters are used as they are. ``device``: None
    means the card.

    ``bucket_source=True`` (default) trims the tokenized prompt to the
    smallest power-of-two column bucket >= the longest real prompt (min 16,
    capped at ``max_source_length``) before the encoders run: every trimmed
    column is pad that the attention masks already exclude. Not under MoE:
    expert capacity quantizes on the padded width, so trimming would change
    which tokens overflow (the reason the config refuses ``bucket_lengths``
    with ``moe_experts``).

    ``pipeline_stages > 1``: decoding runs the same layers with the
    schedule off (one stage, and a mesh without its pipe axis), as the JAX
    package's captioner decodes a pipelined model's parameters through an
    unpipelined one.

    ``decode_int8``: decode through an int8 weight-only copy of the
    transformer (``infer/quantize.py``); the encoders keep the
    full-precision model. ``speculative_draft``: the draft length of
    prompt-lookup speculative decoding for plain greedy requests
    (``infer/speculative.py``); 0 is off, None reads
    ``KLAB_DECODE_SPECULATIVE`` (unset is 0), and a value that is not a
    non-negative integer raises ``ValueError``.
    """

    def __init__(self, config: Config,
                 state_dict_or_model: Union[Mapping[str, torch.Tensor],
                                            MultiModalModel],
                 tokenizer: TokenizerBase, bucket_source: bool = True,
                 device=None, decode_int8: bool = False,
                 speculative_draft: Optional[int] = None):
        if config.pipeline_stages > 1:
            # One process and one stage: the mesh's pipe axis goes too.
            pipe = config.mesh_axis_names.index("pipe")

            def unpiped(shape):
                return tuple(1 if i == pipe else s
                             for i, s in enumerate(shape))

            config = dataclasses.replace(
                config, pipeline_stages=1, pipeline_microbatches=0,
                mesh_shape=unpiped(config.mesh_shape),
                dcn_mesh_shape=unpiped(config.dcn_mesh_shape))
        self.config = config
        self.device = resolve_device(device)
        if isinstance(state_dict_or_model, MultiModalModel):
            model = state_dict_or_model
            first = next(model.parameters())
            if first.device.type != self.device.type:
                raise ValueError(f"model is on {first.device}, captioner "
                                 f"device is {self.device}")
        else:
            model = MultiModalModel(config, device=self.device)
            model.load_state_dict(state_dict_or_model, strict=True)
        self.model = model.eval()
        self.tokenizer = tokenizer
        self.bucket_source = bucket_source
        if speculative_draft is None:
            speculative_draft = _speculative_from_env()
        elif speculative_draft < 0:
            raise ValueError(f"speculative_draft must be >= 0, got "
                             f"{speculative_draft}")
        self.speculative_draft = speculative_draft
        self.decode_model = model.transformer
        if decode_int8:
            from .quantize import quantize_for_decode

            self.decode_model = quantize_for_decode(model.transformer)

    def _decoding(self):
        """fp32 compute and one pipeline stage for the length of a call
        (see the class doc): a model passed in, such as a trainer's, may
        have either otherwise."""
        ctx = contextlib.ExitStack()
        if self.model.dtype != torch.float32:
            ctx.enter_context(self.model.computing_in(torch.float32))
        if self.model.transformer.encoder.pipeline_stages > 1:
            ctx.enter_context(self.model.unpipelined())
        return ctx

    def caption(self, images_uint8: np.ndarray,
                prompts: Optional[Sequence[str]] = None,
                max_length: Optional[int] = None,
                num_beams: Optional[int] = None,
                do_sample: bool = False, temperature: float = 1.0,
                top_k: int = 0, top_p: float = 1.0,
                generator: Optional[torch.Generator] = None,
                min_length: int = 0, repetition_penalty: float = 1.0,
                no_repeat_ngram_size: int = 0) -> list[str]:
        """images (B, H, W, 3) uint8 -> captions."""
        return self.caption_finish(self.caption_launch(
            images_uint8, prompts, max_length=max_length,
            num_beams=num_beams, do_sample=do_sample,
            temperature=temperature, top_k=top_k, top_p=top_p,
            generator=generator, min_length=min_length,
            repetition_penalty=repetition_penalty,
            no_repeat_ngram_size=no_repeat_ngram_size))

    @torch.inference_mode()
    def caption_launch(self, images_uint8: np.ndarray,
                       prompts: Optional[Sequence[str]] = None,
                       max_length: Optional[int] = None,
                       num_beams: Optional[int] = None,
                       do_sample: bool = False, temperature: float = 1.0,
                       top_k: int = 0, top_p: float = 1.0,
                       generator: Optional[torch.Generator] = None,
                       min_length: int = 0, repetition_penalty: float = 1.0,
                       no_repeat_ngram_size: int = 0) -> torch.Tensor:
        """Encode prefill + decode loop; returns the (B, max_length) token
        ids on the device. The decode loop reads a flag back every pass, so
        this returns when decoding is done; ``caption_finish`` reads the ids
        back. ``generator``: the sampling draws' source, on the device."""
        cfg = self.config
        enc_hidden, enc_mask = self._encode_prefill(images_uint8, prompts)
        with self._decoding():
            return generate(
                self.decode_model, enc_hidden, enc_mask,
                max_length=max_length or cfg.generate_max_length,
                num_beams=num_beams or cfg.num_beams, do_sample=do_sample,
                temperature=temperature, top_k=top_k, top_p=top_p,
                generator=generator, min_length=min_length,
                repetition_penalty=repetition_penalty,
                no_repeat_ngram_size=no_repeat_ngram_size,
                speculative_draft=self.speculative_draft)

    def caption_finish(self, ids: torch.Tensor) -> list[str]:
        """Read the ids back to the host and detokenize."""
        return self.tokenizer.batch_decode(ids.cpu().numpy(),
                                           skip_special_tokens=True)

    def caption_stream(self, images_uint8: np.ndarray,
                       prompts: Optional[Sequence[str]] = None,
                       max_length: Optional[int] = None,
                       chunk_size: int = 4, do_sample: bool = False,
                       temperature: float = 1.0, top_k: int = 0,
                       top_p: float = 1.0,
                       generator: Optional[torch.Generator] = None,
                       min_length: int = 0, repetition_penalty: float = 1.0,
                       no_repeat_ngram_size: int = 0
                       ) -> Iterator[tuple[list[str], bool]]:
        """Streaming captioning: yields ``(texts, done)``, the captions
        decoded so far, after the first token and then after every
        ``chunk_size`` tokens. The final texts equal :meth:`caption`'s for
        the same arguments and generator state (greedy and sampling; beams
        do not stream). A model of another compute dtype computes in fp32
        until the stream ends."""
        cfg = self.config
        enc_hidden, enc_mask = self._encode_prefill(images_uint8, prompts)
        with torch.inference_mode(), self._decoding():
            for tokens, n_valid, done in stream_decode(
                    self.decode_model, enc_hidden, enc_mask,
                    max_length=max_length or cfg.generate_max_length,
                    chunk_size=chunk_size, do_sample=do_sample,
                    temperature=temperature, top_k=top_k, top_p=top_p,
                    generator=generator, min_length=min_length,
                    repetition_penalty=repetition_penalty,
                    no_repeat_ngram_size=no_repeat_ngram_size):
                yield (self.tokenizer.batch_decode(
                    tokens[:, :n_valid], skip_special_tokens=True), done)

    @torch.inference_mode()
    def _encode_prefill(self, images_uint8: np.ndarray,
                        prompts: Optional[Sequence[str]]):
        """Tokenize + bucket the prompts, normalize the images, run the
        encoders: the front half of captioning."""
        cfg = self.config
        B = images_uint8.shape[0]
        prompts = list(prompts) if prompts is not None else [COCO_PROMPT] * B
        enc_in = self.tokenizer(prompts, max_length=cfg.max_source_length)
        src_ids = np.asarray(enc_in.input_ids)
        src_mask = np.asarray(enc_in.attention_mask)
        # In reference_pad_quirks mode pads are deliberately attended, and
        # under MoE the padded width sets the capacity: trimming would
        # change results.
        if (self.bucket_source and not cfg.reference_pad_quirks
                and not cfg.moe_experts):
            # Tokenize at full length first so truncation never changes,
            # then trim pad columns to the bucket.
            width = pow2_bucket_width(src_mask, 16)
            src_ids, src_mask = src_ids[:, :width], src_mask[:, :width]
        return self.encode_tokens(images_uint8, src_ids, src_mask)

    @torch.inference_mode()
    def encode_tokens(self, images_uint8: np.ndarray, src_ids: np.ndarray,
                      src_mask: np.ndarray):
        """Encoder prefill from already-tokenized prompts at exactly the
        given source width: normalize the images on the device and run the
        encoders. Returns (encoder hidden (B, L, d), encoder mask (B, L))."""
        dev = self.device
        images = normalize_images(torch.as_tensor(images_uint8).to(dev))
        ids = torch.as_tensor(np.asarray(src_ids)).to(dev)
        mask = torch.as_tensor(np.asarray(src_mask)).to(dev)
        with self._decoding():
            return self.model.encode_for_generation(images, ids, mask)


def _speculative_from_env() -> int:
    """``KLAB_DECODE_SPECULATIVE`` as a draft length (unset: 0)."""
    raw = os.environ.get("KLAB_DECODE_SPECULATIVE", "0")
    try:
        value = int(raw)
    except ValueError:
        value = -1
    if value < 0:
        raise ValueError(f"KLAB_DECODE_SPECULATIVE must be a non-negative "
                         f"integer (a draft length, 0 off), got {raw!r}")
    return value
