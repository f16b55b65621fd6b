"""Optimizer and learning-rate schedules.

Adam (b1 0.9, b2 0.999, eps 1e-8: torch's update is optax's) over the
trainable parameters only, with the schedule as a ``LambdaLR`` stepped once
per optimizer step, so optimizer step ``n`` (0-based) runs at
``make_lr_schedule(config, num_epochs)(n)``, as optax evaluates a schedule
at the update count. The five schedules keep the reference's step counts:
cosine and linear complete after ``num_epochs`` optimizer steps.

Freezing: the text tower is always frozen; the image tower is trainable
only with ``image_model_train`` and without ``freeze_image_model_updates``
(which ``Config`` refuses today: its backward is not ported). Frozen
parameters get ``requires_grad=False`` and stay out of the optimizer.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
from torch import nn

from ..config import Config


def lr_factor(name: str, num_epochs: int) -> Callable[[int], float]:
    """The schedule as a multiple of the base rate, at 0-based step n."""
    if name == "":
        return lambda n: 1.0
    if name == "cosine":
        # CosineAnnealingLR(T_max=num_epochs, eta_min=0)'s closed form; past
        # T_max it rises again, as torch's does.
        return lambda n: 0.5 * (1.0 + math.cos(math.pi * n / num_epochs))
    if name == "linear":
        # LambdaLR(1 - n / num_epochs), clamped at 0 (torch's goes negative).
        return lambda n: max(1.0 - n / num_epochs, 0.0)
    if name == "exponential":
        return lambda n: 0.9 ** n
    if name == "step":
        return lambda n: 0.1 ** (n // 10)
    raise ValueError(f"unknown lr_scheduler {name!r}")


def make_lr_schedule(config: Config, num_epochs: int
                     ) -> Callable[[int], float]:
    """Learning rate at 0-based optimizer step n."""
    factor = lr_factor(config.lr_scheduler, max(num_epochs or 1, 1))
    return lambda n: config.lr * factor(n)


def trainable_names(model: nn.Module, config: Config) -> set[str]:
    """Names of the parameters the optimizer updates: all but the text
    tower's, and the image tower's unless it is trainable and its updates
    are not frozen."""
    image_trainable = (config.image_model_train
                       and not config.freeze_image_model_updates)
    out = set()
    for name, _ in model.named_parameters():
        top = name.split(".")[0]
        if top == "language_model":
            continue
        if top == "image_model" and not image_trainable:
            continue
        out.add(name)
    return out


def make_optimizer(config: Config, model: nn.Module, num_epochs: int
                   ) -> tuple[torch.optim.Optimizer,
                              torch.optim.lr_scheduler.LambdaLR]:
    """(Adam over the trainable parameters, its schedule). Sets
    ``requires_grad=False`` on every other parameter."""
    if config.optimizer != "adam":
        raise NotImplementedError(
            f"optimizer={config.optimizer!r} is not ported yet (ROADMAP "
            "A2.1)")
    names = trainable_names(model, config)
    params = []
    for name, p in model.named_parameters():
        p.requires_grad_(name in names)
        if name in names:
            params.append(p)
    opt = torch.optim.Adam(params, lr=config.lr, betas=(0.9, 0.999),
                           eps=1e-8)
    factor = lr_factor(config.lr_scheduler, max(num_epochs or 1, 1))
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, factor)
