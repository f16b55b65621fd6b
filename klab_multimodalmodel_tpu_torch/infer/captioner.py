"""End-to-end captioning: uint8 images + prompt -> decoded strings."""

from __future__ import annotations

from typing import Mapping, Optional, Sequence, Union

import numpy as np
import torch

from ..config import Config
from ..data.datasets import COCO_PROMPT
from ..data.image_ops import normalize_images
from ..models.multimodal import MultiModalModel
from ..text.tokenizer import TokenizerBase
from ..utils.bucketing import pow2_bucket_width
from ..utils.device import resolve_device
from .generate import generate


class Captioner:
    """Batched greedy caption generation, in fp32.

    ``state_dict_or_model``: a ``MultiModalModel`` state dict (loaded with
    ``strict=True`` into a model built here), or a ``MultiModalModel``
    already on ``device``. ``device``: None means the card.

    ``bucket_source=True`` (default) trims the tokenized prompt to the
    smallest power-of-two column bucket >= the longest real prompt (min 16,
    capped at ``max_source_length``) before the encoders run: every trimmed
    column is pad that the attention masks already exclude.
    """

    def __init__(self, config: Config,
                 state_dict_or_model: Union[Mapping[str, torch.Tensor],
                                            MultiModalModel],
                 tokenizer: TokenizerBase, bucket_source: bool = True,
                 device=None):
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

    def caption(self, images_uint8: np.ndarray,
                prompts: Optional[Sequence[str]] = None,
                max_length: Optional[int] = None,
                num_beams: Optional[int] = None,
                do_sample: bool = False, min_length: int = 0,
                repetition_penalty: float = 1.0,
                no_repeat_ngram_size: int = 0) -> list[str]:
        """images (B, H, W, 3) uint8 -> captions."""
        return self.caption_finish(self.caption_launch(
            images_uint8, prompts, max_length=max_length,
            num_beams=num_beams, do_sample=do_sample, min_length=min_length,
            repetition_penalty=repetition_penalty,
            no_repeat_ngram_size=no_repeat_ngram_size))

    @torch.inference_mode()
    def caption_launch(self, images_uint8: np.ndarray,
                       prompts: Optional[Sequence[str]] = None,
                       max_length: Optional[int] = None,
                       num_beams: Optional[int] = None,
                       do_sample: bool = False, min_length: int = 0,
                       repetition_penalty: float = 1.0,
                       no_repeat_ngram_size: int = 0) -> torch.Tensor:
        """Encode prefill + decode loop; returns the (B, max_length) token
        ids on the device. ``caption_finish`` reads them back."""
        enc_hidden, enc_mask = self._encode_prefill(images_uint8, prompts)
        cfg = self.config
        return generate(
            self.model.transformer, enc_hidden, enc_mask,
            max_length=max_length or cfg.generate_max_length,
            num_beams=num_beams or cfg.num_beams, do_sample=do_sample,
            min_length=min_length, repetition_penalty=repetition_penalty,
            no_repeat_ngram_size=no_repeat_ngram_size)

    def caption_finish(self, ids: torch.Tensor) -> list[str]:
        """Read the ids back to the host and detokenize."""
        return self.tokenizer.batch_decode(ids.cpu().numpy(),
                                           skip_special_tokens=True)

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
        # In reference_pad_quirks mode pads are deliberately attended, so
        # trimming them would change results.
        if self.bucket_source and not cfg.reference_pad_quirks:
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
        return self.model.encode_for_generation(images, ids, mask)
