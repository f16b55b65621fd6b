"""Optimizers and learning-rate schedules.

The JAX package's two optimizers, over the trainable parameters only, with
the schedule as a ``LambdaLR`` stepped once per optimizer step, so optimizer
step ``n`` (0-based) runs at ``make_lr_schedule(config, num_epochs)(n)``, as
optax evaluates a schedule at the update count. The five schedules keep the
reference's step counts: cosine and linear complete after ``num_epochs``
optimizer steps.

* ``optimizer='adam'`` (b1 0.9, b2 0.999, eps 1e-8, the reference's
  torch defaults): ``torch.optim.Adam``,
  whose update is optax's, with both moments fp32; with
  ``adam_mu_dtype='bfloat16'``, ``AdamBf16Mu``, optax's ``scale_by_adam``
  with a bf16 first moment.
* ``optimizer='adafactor'``: ``Adafactor``, what ``optax.adafactor(
  learning_rate, multiply_by_parameter_scale=False)`` builds.

Freezing: the text tower is always frozen; the image tower is trainable
only with ``image_model_train`` and without ``freeze_image_model_updates``.
Frozen parameters get ``requires_grad=False`` and stay out of the optimizer.

Sharded parameters (DTensors, under FSDP2 and tensor parallelism) take the
same updates: Adam's and ``AdamBf16Mu``'s are elementwise and run on each
rank's shards; ``Adafactor``'s factored statistics and its block RMS are
means over whole parameters, which the JAX package gets from XLA, so it
gathers each gradient whole, computes one process's update and applies
the rank's shard of it (a mean over a shard alone would be silently
wrong).

Under the ``pipe`` and ``expert`` axes, and for MoE banks under ``tensor``,
each rank's optimizer holds its own parameters only (its stage's blocks,
its experts' slices of the banks, cut on d_ff too under ``tensor``, and the
replicated rest): Adam's state of a local tensor is that slice of one
process's. ``Adafactor`` factors a bank as the whole bank's shape says
(``Adafactor.cuts``): a row or column mean over a dim that ranks cut (the
experts' dim over the expert group, d_ff over the tensor group) is the
mean of the group's means, so a statistic that drops that dim is the same
on the group's ranks, and one that keeps it is the rank's slice. Its block
RMS over a JAX leaf that spans ranks (a scanned stack's blocks, an expert
bank) is summed over the pipe group or the tensor x expert group
(``Adafactor.spread``); the ``fsdp`` and the dense layers' ``tensor``
shards are gathered whole first (above).
"""

from __future__ import annotations

import math
import re
from typing import Callable, Iterable, Optional

import torch
from torch import nn
from torch.distributed.tensor import DTensor

from ..config import Config
from ..parallel.partitioning import gather_full, local_shard


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


# Adam's hyperparameters (torch's defaults, which the reference uses).
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
# optax.adafactor's defaults, which the JAX package uses.
ADAFACTOR_DECAY, ADAFACTOR_EPS, ADAFACTOR_MIN_DIM = 0.8, 1e-30, 128
ADAFACTOR_CLIP = 1.0

# A T5 block's parameter: the JAX package scans the blocks, so one JAX leaf
# holds that parameter of every block of the stack.
_STACKED = re.compile(r"^(.*\.(?:encoder|decoder)\.block\.)\d+(\..*)$")


def jax_leaf_groups(names: Iterable[str]) -> list[list[str]]:
    """The port's parameter names grouped by the JAX leaf that holds them:
    the per-layer tensors of a scanned T5 stack (``transformer.encoder.
    block.{i}.layer.0.SelfAttention.q.weight`` for every i) form one group,
    every other parameter a group of one. Order: first appearance."""
    groups: dict[str, list[str]] = {}
    for name in names:
        m = _STACKED.match(name)
        key = f"{m.group(1)}*{m.group(2)}" if m else name
        groups.setdefault(key, []).append(name)
    return list(groups.values())


class AdamBf16Mu(torch.optim.Optimizer):
    """Adam with its first moment stored in bf16, as the JAX package's
    jitted step computes optax's ``scale_by_adam(mu_dtype=bfloat16)``
    followed by the learning rate: mu = (1 - b1) g + b1 mu in fp32 from the
    stored bf16 moment, with b1 rounded to bf16 (0.8984375 for 0.9: JAX's
    weak-typed scalar takes the moment's dtype, and XLA keeps the product in
    fp32); nu = (1 - b2) g^2 + b2 nu in fp32; the step is -lr (mu / (1 -
    b1^t)) / (sqrt(nu / (1 - b2^t)) + eps) from the fp32 mu, which is then
    stored back in bf16.

    The update runs on lists of tensors (``torch._foreach_*``), a chunk of
    at most ``chunk_elements`` elements at a time: a loop over the tensors
    would launch ~12 kernels each from Python, and whole lists would hold
    fp32 temporaries the size of every parameter."""

    chunk_elements = 1 << 26

    def __init__(self, params, lr: float):
        super().__init__(params, dict(lr=lr))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            for p in params:
                st = self.state[p]
                if not st:
                    st["step"] = 0
                    st["mu"] = torch.zeros_like(p, dtype=torch.bfloat16)
                    st["nu"] = torch.zeros_like(p, dtype=torch.float32)
                st["step"] += 1
            for chunk in _chunks(params, self.chunk_elements):
                self._update(chunk, group)

    def _update(self, params: list, group: dict) -> None:
        b1, b2 = ADAM_B1, ADAM_B2
        states = [self.state[p] for p in params]
        grads = [_local(p.grad) for p in params]
        mus = [_local(st["mu"]) for st in states]
        nus = [_local(st["nu"]) for st in states]
        mu = torch._foreach_mul(grads, 1 - b1)
        torch._foreach_add_(mu, mus, alpha=float(torch.tensor(
            b1, dtype=torch.bfloat16)))
        torch._foreach_copy_(mus, mu)
        g2 = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(g2, 1 - b2)
        torch._foreach_mul_(nus, b2)
        torch._foreach_add_(nus, g2)
        del g2
        steps = [st["step"] for st in states]
        denom = torch._foreach_div(nus, [_bias_correction(b2, t)
                                         for t in steps])
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, ADAM_EPS)
        torch._foreach_div_(mu, [_bias_correction(b1, t) for t in steps])
        torch._foreach_div_(mu, denom)
        torch._foreach_mul_(mu, -group["lr"])
        torch._foreach_add_([_local(p) for p in params], mu)


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's shard on this rank (the tensor itself otherwise):
    elementwise updates run on the shards."""
    return t.to_local() if isinstance(t, DTensor) else t


def _bias_correction(decay: float, t: int) -> float:
    """1 - decay^t in fp32, as optax computes it."""
    return float(1 - _f32(decay) ** t)


def _chunks(tensors: list, max_elements: int):
    """``tensors`` in consecutive runs of at most ``max_elements`` elements
    (a larger tensor alone)."""
    run, size = [], 0
    for t in tensors:
        if run and size + t.numel() > max_elements:
            yield run
            run, size = [], 0
        run.append(t)
        size += t.numel()
    if run:
        yield run


class Adafactor(torch.optim.Optimizer):
    """``optax.adafactor(learning_rate, multiply_by_parameter_scale=False)``
    with its defaults: ``scale_by_factored_rms`` (decay 1 - (t+1)^-0.8,
    epsilon 1e-30, the second moment factored over the two largest dims
    where the smaller of them is at least 128), then ``clip_by_block_rms
    (1.0)``, then the learning rate, then -1. Not ``torch.optim.Adafactor``,
    whose rule differs.

    Each param group is one clipping block: the RMS that ``clip_by_block_rms``
    takes over a JAX leaf is taken over all the group's tensors together
    (``jax_leaf_groups`` gives the groups: a scanned T5 stack's leaf is the
    per-layer tensors of one parameter). A sharded parameter's gradient is
    gathered whole first; its statistics are then whole tensors, the same
    on every rank, and the rank applies its shard of the update."""

    # Its state is whole for a sharded parameter too (see above).
    whole_state = True

    def __init__(self, params, lr: float):
        super().__init__(params, dict(lr=lr))
        # (process group, the indices of the param groups whose JAX leaf
        # spans its ranks), set under the pipe or expert axis and for MoE
        # banks under tensor: those groups' sums of squares and sizes are
        # summed over it.
        self.spread: Optional[tuple] = None
        # {parameter: (its whole shape, {a dim that ranks cut in equal
        # slices: the process group of those ranks})}: a bank's.
        self.cuts: dict = {}

    @torch.no_grad()
    def step(self, closure=None):
        import torch.distributed as dist

        blocks = []
        for group in self.param_groups:
            pairs = [(p, self._scaled(p)) for p in group["params"]
                     if p.grad is not None]
            sq = sum((u * u).sum() for _, u in pairs) if pairs else None
            blocks.append((pairs, sq, sum(u.numel() for _, u in pairs)))
        if self.spread is not None:
            pg, spread = self.spread
            dev = next(p for g in self.param_groups for p in g["params"]
                       ).device
            sums = torch.stack([torch.stack([
                blocks[i][1] if blocks[i][1] is not None
                else torch.zeros((), device=dev),
                torch.tensor(float(blocks[i][2]), device=dev)])
                for i in spread])
            dist.all_reduce(sums, group=pg)
            for i, (sq, n) in zip(spread, sums):
                blocks[i] = (blocks[i][0], sq, n)
        for pairs, sq, n in blocks:
            if not pairs:
                continue
            rms = torch.sqrt(sq / n)
            denom = torch.clamp(rms / ADAFACTOR_CLIP, min=1.0)
            for p, u in pairs:
                step = -(group["lr"] * (u / denom))
                if isinstance(p, DTensor):
                    p.to_local().add_(local_shard(step, p))
                else:
                    p.add_(step)

    def _scaled(self, p: torch.Tensor) -> torch.Tensor:
        """``scale_by_factored_rms`` of one tensor: updates its state and
        returns g / sqrt(v) with v the (factored) second-moment estimate
        (whole, for a sharded parameter too; of the rank's slice, with the
        whole slice's means, for a cut one)."""
        g = gather_full(p.grad)
        st = self.state[p]
        whole, cut = self.cuts.get(p, (tuple(g.shape), {}))
        dims = _factored_dims(whole)
        if not st:
            st["step"] = 0
            if dims is None:
                st["v"] = torch.zeros_like(g)
            else:
                d1, d0 = dims
                st["v_row"] = g.new_zeros(_drop(g.shape, d0))
                st["v_col"] = g.new_zeros(_drop(g.shape, d1))
        decay = 1.0 - _f32(st["step"] + 1) ** -ADAFACTOR_DECAY
        st["step"] += 1
        g_sq = g * g + ADAFACTOR_EPS
        if dims is None:
            v = st["v"] = decay * st["v"] + (1.0 - decay) * g_sq
            return g * v ** -0.5
        d1, d0 = dims
        v_row = st["v_row"] = (decay * st["v_row"] + (1.0 - decay)
                               * self._mean(g_sq, d0, cut.get(d0)))
        v_col = st["v_col"] = (decay * st["v_col"] + (1.0 - decay)
                               * self._mean(g_sq, d1, cut.get(d1)))
        reduced_d1 = d1 - 1 if d1 > d0 else d1
        row_col_mean = self._mean(v_row, reduced_d1, cut.get(d1),
                                  keepdim=True)
        row_factor = (v_row / row_col_mean) ** -0.5
        col_factor = v_col ** -0.5
        return g * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)

    @staticmethod
    def _mean(t: torch.Tensor, dim: int, group,
              keepdim: bool = False) -> torch.Tensor:
        """``t``'s mean over ``dim``; where ``group``'s ranks cut ``dim``
        (equal slices), the mean of the group's means."""
        m = t.mean(dim, keepdim=keepdim)
        if group is None:
            return m
        import torch.distributed as dist

        dist.all_reduce(m, group=group)
        return m / dist.get_world_size(group)


def _f32(x) -> torch.Tensor:
    """x as an fp32 scalar tensor: optax computes its step-dependent
    factors in fp32."""
    return torch.tensor(x, dtype=torch.float32)


def _factored_dims(shape):
    """optax's ``_factored_dims``: (second largest, largest) dim, or None
    below two dims or where the second largest is under the threshold."""
    if len(shape) < 2:
        return None
    order = sorted(range(len(shape)), key=lambda i: shape[i])
    if shape[order[-2]] < ADAFACTOR_MIN_DIM:
        return None
    return order[-2], order[-1]


def _drop(shape, dim: int) -> tuple:
    return tuple(s for i, s in enumerate(shape) if i != dim)


def state_dim(key: str, shape: tuple, dim: int) -> Optional[int]:
    """The dim of an optimizer state entry ``key`` of a parameter of
    ``shape`` that runs along the parameter's dim ``dim``, or None where
    the entry has no such dim (``Adafactor``'s row statistic drops the
    largest factored dim, its column statistic the other: a bank whose
    experts' dim is factored has a statistic that keeps that dim, a slice
    on an expert split, and one that drops it, the same on every expert
    rank)."""
    dims = _factored_dims(shape)
    if key not in ("v_row", "v_col") or dims is None:
        return dim
    dropped = dims[1] if key == "v_row" else dims[0]
    if dim == dropped:
        return None
    return dim - 1 if dim > dropped else dim


def state_piece(key: str, shape: tuple, piece: Optional[tuple],
                ndim: int) -> Optional[tuple]:
    """The piece of an optimizer state entry ``key`` (of ``ndim`` dims)
    of a parameter of the whole ``shape`` that a rank holding the
    parameter's ``piece`` (``parallel.partitioning.rank_piece``) holds:
    ``piece`` on the dims ``state_dim`` maps (a 0-d entry, a step count,
    whole); None where it holds no piece of the parameter."""
    if piece is None:
        return None
    out = [None] * ndim
    if ndim:
        for d, span in enumerate(piece):
            j = state_dim(key, shape, d)
            if j is not None:
                out[j] = span
    return tuple(out)


def optimizer_state(whole: dict, groups: list,
                    hyper: dict) -> dict:
    """The one-process optimizer state dict ({"state", "param_groups"})
    from whole entries "optimizer/{name}/{key}" (``assemble``'s) and the
    whole model's param groups of names."""
    by_name: dict = {}
    for entry, v in whole.items():
        _, name, key = entry.split("/")
        by_name.setdefault(name, {})[key] = v
    flat = [n for g in groups for n in g]
    out, i = [], 0
    for g in groups:
        out.append(dict(hyper, params=list(range(i, i + len(g)))))
        i += len(g)
    return {"state": {i: by_name[n] for i, n in enumerate(flat)
                      if n in by_name}, "param_groups": out}


def optimizer_groups(config: Config, names: Iterable[str]
                     ) -> list[list[str]]:
    """The optimizer's param groups, as lists of trainable parameter
    names in the model's order: one group (Adam), or one per JAX leaf
    (``Adafactor``'s clipping blocks)."""
    names = list(names)
    if config.optimizer == "adafactor":
        return jax_leaf_groups(names)
    return [names]


def make_optimizer(config: Config, model: nn.Module, num_epochs: int
                   ) -> tuple[torch.optim.Optimizer,
                              torch.optim.lr_scheduler.LambdaLR]:
    """(The configured optimizer over the trainable parameters, its
    schedule). Sets ``requires_grad=False`` on every other parameter."""
    names = trainable_names(model, config)
    params = {}
    for name, p in model.named_parameters():
        p.requires_grad_(name in names)
        if name in names:
            params[name] = p
    groups = optimizer_groups(config, params)
    if config.optimizer == "adafactor":
        opt = Adafactor([{"params": [params[n] for n in g]}
                         for g in groups], lr=config.lr)
    elif config.adam_mu_dtype == "bfloat16":
        opt = AdamBf16Mu(params.values(), lr=config.lr)
    else:
        opt = torch.optim.Adam(params.values(), lr=config.lr,
                               betas=(ADAM_B1, ADAM_B2), eps=ADAM_EPS)
    factor = lr_factor(config.lr_scheduler, max(num_epochs or 1, 1))
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, factor)
