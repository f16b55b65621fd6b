"""The single-device training step of the cascade.

The port of the JAX package's ``train/trainer.py`` on one card: device-side
image normalization in the compute dtype, the frozen towers' forwards under
``torch.no_grad()``, the trainable parts' forward and backward (the
transformer, the projections and, with ``image_model_train``, the SwinV2
tower; the attention through the hand-written kernels when the kernel flags
are on), gradient accumulation over ``accumulation_steps`` microbatches, and
the update (Adam, Adam with a bf16 first moment, or Adafactor;
``train/optim.py``). With ``frozen_param_dtype='bfloat16'`` the frozen
towers' parameters are stored in bf16, as the JAX package's
``_maybe_cast_frozen`` stores them. The JAX package's mesh, sharding and
buffer donation have no counterpart on one device.

Dropout draws from the ``torch.Generator`` passed to each step, on the
model's device; the JAX package's dropout key becomes that generator.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Union

import numpy as np
import torch

from ..config import Config
from ..data.image_ops import normalize_images
from ..models.multimodal import MultiModalModel
from ..utils.device import resolve_device
from ..utils.precision import get_policy
from .optim import make_optimizer

Batch = Mapping[str, Union[np.ndarray, torch.Tensor]]


@dataclasses.dataclass
class Trainer:
    """Owns the model (fp32 parameters, the frozen ones in
    ``frozen_param_dtype``; compute dtype from the config's policy), the
    optimizer and its schedule. ``device``: None means the card."""

    config: Config
    num_epochs: int = 1
    device: Optional[Union[str, torch.device]] = None

    def __post_init__(self):
        cfg = self.config
        self.device = resolve_device(self.device)
        self.policy = get_policy(cfg.compute_dtype, cfg.param_dtype)
        self.model = MultiModalModel(cfg, dtype=self.policy.compute_dtype,
                                     device=self.device)
        self.optimizer: Optional[torch.optim.Optimizer] = None
        self.scheduler = None
        self.step = 0

    # -- state creation ----------------------------------------------------
    def init_state(self, generator: Optional[torch.Generator] = None,
                   state_dict: Optional[Mapping[str, torch.Tensor]] = None
                   ) -> MultiModalModel:
        """Seeded random weights (``generator``, or one seeded with
        ``config.seed`` on the device), or ``state_dict`` (for example from
        ``checkpoint.from_jax.convert_jax_params``); then a fresh optimizer
        over the trainable parameters, and the frozen parameters cast to
        ``frozen_param_dtype``. Returns the model."""
        if state_dict is not None:
            self.model.load_state_dict(state_dict, strict=True)
        else:
            if generator is None:
                generator = torch.Generator(device=self.device).manual_seed(
                    self.config.seed)
            self.model.init_weights(generator)
        self.optimizer, self.scheduler = make_optimizer(
            self.config, self.model, self.num_epochs)
        if self.config.frozen_param_dtype == "bfloat16":
            # They feed bf16 compute and take no update; the buffers (window
            # masks, coordinate tables) stay fp32.
            for p in self.model.parameters():
                if not p.requires_grad:
                    p.data = p.data.to(torch.bfloat16)
        self.step = 0
        return self.model

    def to_device(self, batch: Batch) -> dict:
        """The batch on the model's device. Host arrays go to the card
        through pinned memory, asynchronously: a blocking copy would wait
        for the steps already enqueued."""
        out = {}
        for k, v in batch.items():
            t = torch.as_tensor(v)
            if self.device.type == "cuda" and t.device.type == "cpu":
                t = t.pin_memory().to(self.device, non_blocking=True)
            out[k] = t.to(self.device)
        return out

    def copy_to_host(self, tensors) -> "HostCopy":
        """Start copying ``tensors`` (a step's tower features) to the host
        behind the work enqueued so far; ``wait()`` on the result returns
        them."""
        return HostCopy(tuple(tensors), self.device)

    # -- losses ------------------------------------------------------------
    def _loss(self, batch: dict, generator, deterministic: bool
              ) -> torch.Tensor:
        model = self.model
        if "image_features" in batch:
            # Cached tower features: the same loss as from the images.
            return model.loss_from_image_features(
                batch["image_features"], batch["source_ids"],
                batch["target_ids"], source_mask=batch.get("source_mask"),
                target_mask=batch.get("target_mask"),
                language_features=batch.get("language_features"),
                deterministic=deterministic, generator=generator).loss
        images = normalize_images(batch["images"],
                                  dtype=self.policy.compute_dtype)
        return model(images, batch["source_ids"], batch["target_ids"],
                     source_mask=batch.get("source_mask"),
                     target_mask=batch.get("target_mask"),
                     deterministic=deterministic, generator=generator).loss

    def _features_then_loss(self, batch: dict, generator,
                            deterministic: bool):
        """(loss, (image features, language features)): the frozen towers'
        outputs surfaced for a feature cache."""
        images = normalize_images(batch["images"],
                                  dtype=self.policy.compute_dtype)
        img = self.model.image_features(images)
        lang = self.model.language_features(batch["source_ids"],
                                            batch.get("source_mask"))
        fbatch = {k: v for k, v in batch.items() if k != "images"}
        fbatch["image_features"] = img
        fbatch["language_features"] = lang
        return self._loss(fbatch, generator, deterministic), (img, lang)

    # -- steps -------------------------------------------------------------
    def train_step(self, batch: Batch,
                   generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
        """One optimizer step on ``batch``; returns the mean microbatch loss
        (a 0-d tensor on the device: reading it syncs). The gradients stay
        in the parameters' ``.grad`` until the next step."""
        return self._train_step(batch, generator, with_features=False)

    def train_step_with_features(self, batch: Batch,
                                 generator: Optional[torch.Generator] = None):
        """``train_step`` that also returns the frozen towers' outputs,
        (loss, (image features, language features))."""
        return self._train_step(batch, generator, with_features=True)

    def _train_step(self, batch: Batch, generator, with_features: bool):
        if self.optimizer is None:
            raise RuntimeError("Trainer.init_state() first")
        batch = self.to_device(batch)
        accum = max(self.config.accumulation_steps, 1)
        rows = next(iter(batch.values())).shape[0]
        if rows % accum:
            raise ValueError(f"batch of {rows} rows is not a multiple of "
                             f"accumulation_steps={accum}")
        b = rows // accum
        self.optimizer.zero_grad(set_to_none=True)
        loss_sum = torch.zeros((), device=self.device)
        feats = []
        for i in range(accum):
            mb = {k: v[i * b:(i + 1) * b] for k, v in batch.items()}
            if with_features:
                loss, f = self._features_then_loss(mb, generator, False)
                feats.append(f)
            else:
                loss = self._loss(mb, generator, False)
            loss.backward()  # sums the microbatches' gradients
            loss_sum = loss_sum + loss.detach()
        if accum > 1:
            for group in self.optimizer.param_groups:
                for p in group["params"]:
                    if p.grad is not None:
                        p.grad.div_(accum)
        self.optimizer.step()
        self.scheduler.step()
        self.step += 1
        loss = loss_sum / accum
        if with_features:
            return loss, tuple(torch.cat(parts) for parts in zip(*feats))
        return loss

    @torch.no_grad()
    def eval_step(self, batch: Batch) -> torch.Tensor:
        """Deterministic loss of ``batch``, no update."""
        return self._loss(self.to_device(batch), None, True)

    @torch.no_grad()
    def eval_step_with_features(self, batch: Batch):
        """``eval_step`` that also returns the frozen towers' outputs."""
        return self._features_then_loss(self.to_device(batch), None, True)


class HostCopy:
    """Device tensors on their way to the host. On the card: copies into
    pinned buffers, asynchronous, and an event recorded after them; the
    device tensors are held until the event completes. On the CPU: clones.
    ``wait()`` blocks until the copies are done and returns them."""

    def __init__(self, tensors: tuple, device: torch.device):
        self._src = tensors
        self._event = None
        if device.type == "cuda":
            self._host = tuple(
                torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(
                    t, non_blocking=True) for t in tensors)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = tuple(t.detach().clone() for t in tensors)

    def wait(self) -> tuple:
        if self._event is not None:
            self._event.synchronize()
        self._src = None
        return self._host
