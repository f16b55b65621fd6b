"""Parameter layouts over the ``(data, fsdp, tensor)`` mesh, and the
sharding of the port's model by them.

The port of the JAX package's ``parallel/partitioning.py``. ``_RULES`` maps
a parameter's name (the HF-style names of the port's modules) to its
layout: for each torch dim, the mesh axis that shards it, or None. The
rules are the JAX package's, read through the port's layouts: torch keeps a
linear weight as (out, in) and a convolution's as (out, in, kh, kw) where
flax keeps (in, out) and (kh, kw, in, out), so a JAX ``P("fsdp",
"tensor")`` on a q kernel is ``("tensor", "fsdp")`` here; embeddings,
relative-position tables and expert banks keep the JAX layout. Axes:

* ``data``: rows only, parameters replicated;
* ``fsdp``: ZeRO-style sharding of one weight dim, by FSDP2
  (``fully_shard``) over ``(data, fsdp)`` (HSDP: replicated over data);
* ``tensor``: Megatron tensor parallelism by DTensor (``parallelize_module``):
  q/k/v and ``wi`` column-parallel (heads and d_ff local), ``o`` and ``wo``
  row-parallel, the shared embedding row-parallel over the vocab, the LM
  head and the projections column-parallel.

``parallelize`` applies them to a model, with these differences from the
rules, each for a reason it states:

* the SwinV2 tower stays replicated over ``tensor``: its 88 M parameters
  weigh little beside a T5-3B's, and splitting it would add an all-gather
  after every ``patch_embed_proj``, ``reduction`` and ``fc1``;
* FSDP2 shards every parameter, also those the rules replicate (norms,
  relative-position tables, the Swin position-bias MLP): those go on dim
  0, as does any parameter whose rule's ``fsdp`` dim does not divide by
  the axis (``fsdp_dim``). Numerics do not depend on the dim; per-rank
  bytes do.

The ``seq`` axis replicates every parameter, as ``data`` does; its
ranks split the positions of each T5 stack (``SeqSlice``): ``seq_shard``
is the port of the JAX package's ``seq_constraint``, ``seq_gather`` the
all-gather that XLA inserts for attention's keys and values (and the
reduce-scatter of their gradient). ``tick_constraint``,
``pipe_constraint`` and ``expert_constraint`` belong to the ``pipe`` and
``expert`` axes (ROADMAP A12d) and are not ported.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Iterable, Mapping, Optional

import torch
from torch import nn

Spec = tuple  # one entry per torch dim: an axis name or None

# (regex on the parameter name, spec of the trailing dims). The first rule
# that matches wins; a spec longer than the parameter's rank replicates it,
# a shorter one is padded with None on the left (the JAX package's leading
# layer axis; the port's layers are separate parameters).
_RULES: list[tuple[str, Spec]] = [
    # T5 attention: q/k/v project d_model -> heads x d_kv (heads on
    # tensor, d_model on fsdp); o projects back.
    (r"SelfAttention\.(q|k|v)\.weight$", ("tensor", "fsdp")),
    (r"SelfAttention\.o\.weight$", ("fsdp", "tensor")),
    (r"EncDecAttention\.(q|k|v)\.weight$", ("tensor", "fsdp")),
    (r"EncDecAttention\.o\.weight$", ("fsdp", "tensor")),
    # T5 MLP: wi (and the gated wi_0 / wi_1) expand d_ff on tensor, wo
    # contracts.
    (r"DenseReluDense\.wi(_[01])?\.weight$", ("tensor", "fsdp")),
    (r"DenseReluDense\.wo\.weight$", ("fsdp", "tensor")),
    # MoE expert banks (E, D, F) / (E, F, D), the JAX layout; the router
    # stays replicated.
    (r"mlp\.experts_wi$", ("expert", "fsdp", "tensor")),
    (r"mlp\.experts_wo$", ("expert", "tensor", "fsdp")),
    (r"mlp\.router\.weight$", (None, None)),
    # Embedding (vocab, d) and LM head (vocab, d): vocab on tensor.
    (r"(^|\.)shared\.weight$", ("tensor", "fsdp")),
    (r"(^|\.)lm_head\.weight$", ("tensor", "fsdp")),
    # Relative-position tables: tiny, replicated.
    (r"relative_attention_bias\.weight$", (None, None)),
    # SwinV2 attention and MLP dense layers.
    (r"attention\.self\.(query|key|value)\.weight$", ("tensor", "fsdp")),
    (r"attention\.output\.dense\.weight$", ("fsdp", "tensor")),
    (r"attention\.self\.(query|value)\.bias$", ("tensor",)),
    (r"attention\.output\.dense\.bias$", ("fsdp",)),
    (r"attention\.self\.logit_scale$", (None,)),
    (r"continuous_position_bias_mlp\.\d+\.(weight|bias)$", (None, None)),
    (r"(intermediate|output)\.dense\.weight$", ("tensor", "fsdp")),
    (r"(intermediate|output)\.dense\.bias$", ("tensor",)),
    (r"downsample\.reduction\.weight$", ("tensor", "fsdp")),
    (r"patch_embeddings\.projection\.weight$", ("tensor", None, None, None)),
    (r"patch_embeddings\.projection\.bias$", ("tensor",)),
    # Projections between the towers.
    (r"(vision|language)_projection\.weight$", ("tensor", "fsdp")),
]


def spec_for_path(name: str, ndim: int) -> Spec:
    """The layout of one parameter of rank ``ndim``: a tuple of ``ndim``
    entries, each the mesh axis that shards that torch dim or None. The
    port's names carry no pipeline stages: the GPipe schedule keeps its
    layers' names (the ``pipe`` axis is ROADMAP A12d)."""
    for pattern, trailing in _RULES:
        if re.search(pattern, name):
            if len(trailing) > ndim:
                return (None,) * ndim
            return (None,) * (ndim - len(trailing)) + tuple(trailing)
    return (None,) * ndim


def make_param_specs(module: nn.Module) -> dict[str, Spec]:
    """{parameter name: ``spec_for_path``} over ``module``'s parameters
    (also on the meta device)."""
    return {name: spec_for_path(name, p.dim())
            for name, p in module.named_parameters()}


def mesh_axis_size(name: str, mesh=None) -> int:
    """Size of a named axis of ``mesh`` (a ``utils.mesh.Mesh``; 1 for an
    absent axis or no mesh). The JAX package reads the ambient mesh;
    PyTorch has none, so the caller passes it."""
    if mesh is None:
        return 1
    return mesh.size(name)


def batch_spec() -> Spec:
    """Input batches: the leading (row) dim over the data-like axes. A
    rank's rows are the chunk of its data x fsdp index
    (``Mesh.dp_rank``); the ranks of one tensor group share them."""
    return (("data", "fsdp"),)


def fsdp_dim(name: str, shape: tuple, fsdp: int) -> int:
    """The dim FSDP2 shards a parameter on: the rule's ``fsdp`` dim where
    it divides by the axis, else dim 0 (a rule that replicates over
    ``fsdp``, or an uneven dim: FSDP2 pads dim 0's last shard)."""
    spec = spec_for_path(name, len(shape))
    if "fsdp" in spec:
        d = spec.index("fsdp")
        if shape[d] % fsdp == 0:
            return d
    return 0


def tensor_parallel(name: str) -> bool:
    """Whether ``parallelize`` splits a parameter over ``tensor``: its rule
    names the axis (at any rank: 4 dims hold every rule) and it is not the
    SwinV2 tower's (replicated by design)."""
    if name.startswith("image_model."):
        return False
    return "tensor" in spec_for_path(name, 4)


# ---------------------------------------------------------------------------
# Per-rank bytes
# ---------------------------------------------------------------------------


def applied_spec(name: str, shape: tuple, axis_sizes: Mapping[str, int]
                 ) -> tuple:
    """The mesh axes on each dim as ``parallelize`` lays a parameter out:
    ``tensor`` where the rules put it (not on the Swin tower), ``fsdp`` on
    ``fsdp_dim``. Entries are tuples of axis names."""
    spec = spec_for_path(name, len(shape))
    out = [[] for _ in shape]
    if tensor_parallel(name) and axis_sizes.get("tensor", 1) > 1:
        out[spec.index("tensor")].append("tensor")
    if shape and axis_sizes.get("fsdp", 1) > 1:
        out[fsdp_dim(name, shape, axis_sizes["fsdp"])].append("fsdp")
    return tuple(tuple(a) for a in out)


def shard_numel(shape: tuple, spec: tuple, axis_sizes: Mapping[str, int]
                ) -> int:
    """Elements of one rank's shard: each dim divided (rounding up, as
    DTensor and FSDP2 chunk) by the sizes of the axes that shard it."""
    n = 1
    for size, axes in zip(shape, spec):
        for a in (axes,) if isinstance(axes, str) else (axes or ()):
            size = math.ceil(size / axis_sizes.get(a, 1))
        n *= size
    return n


def per_rank_bytes(named_shapes: Iterable[tuple[str, tuple, bool]],
                   axis_sizes: Mapping[str, int],
                   moment_bytes: int = 8) -> dict[str, int]:
    """Bytes of parameters (fp32), gradients (fp32) and Adam's two fp32
    moments (``moment_bytes`` per element) on one rank, for parameters
    given as (name, shape, trainable) and laid out as ``parallelize`` lays
    them over ``axis_sizes``. Frozen parameters have no gradient and no
    moments."""
    params = grads = moments = 0
    for name, shape, trainable in named_shapes:
        n = shard_numel(shape, applied_spec(name, shape, axis_sizes),
                        axis_sizes)
        params += 4 * n
        if trainable:
            grads += 4 * n
            moments += moment_bytes * n
    return dict(params=params, grads=grads, moments=moments,
                total=params + grads + moments)


# ---------------------------------------------------------------------------
# Whole tensors from shards, and shards from whole tensors
# ---------------------------------------------------------------------------


def _chunk_sizes(size: int, n: int) -> list[int]:
    """The sizes ``torch.chunk`` (DTensor's ``Shard``) gives ``n`` ranks
    along a dim of ``size``; ranks past the last chunk hold 0."""
    sizes = [len(c) for c in torch.arange(size).chunk(n)]
    return sizes + [0] * (n - len(sizes))


def _shard_dims(t) -> list[tuple[int, int]]:
    """(mesh dim, tensor dim) of each ``Shard`` placement of the DTensor
    ``t``; raises on a placement that is neither ``Shard`` nor
    ``Replicate``, or on a tensor dim sharded twice (the layouts here never
    do either)."""
    from torch.distributed.tensor import Shard

    out = []
    for i, p in enumerate(t.placements):
        if p.is_replicate():
            continue
        if type(p) is not Shard:
            raise ValueError(f"placement {p} of a {tuple(t.shape)} DTensor: "
                             "only Shard and Replicate are taken")
        out.append((i, p.dim))
    if len({d for _, d in out}) != len(out):
        raise ValueError(f"placements {t.placements}: a dim sharded twice")
    return out


def gather_full(t: torch.Tensor) -> torch.Tensor:
    """The whole tensor of a DTensor (a plain tensor is returned as it
    is), on every rank of its mesh, gathered with one
    ``all_gather_into_tensor`` per sharded mesh dim over that dim's group.
    Not ``DTensor.full_tensor``: its functional collectives crash with
    gloo on CUDA tensors (several ranks sharing one card, torch 2.11),
    where the c10d ones FSDP2 uses work."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    if not isinstance(t, DTensor):
        return t
    x = t.to_local()
    mesh = t.device_mesh
    for i, d in reversed(_shard_dims(t)):
        n = mesh.size(i)
        sizes = _chunk_sizes(t.shape[d], n)
        pad = list(x.shape)
        pad[d] = sizes[0]
        padded = x.new_zeros(pad)
        padded.narrow(d, 0, x.shape[d]).copy_(x)
        out = x.new_empty([n * pad[0]] + pad[1:])
        dist.all_gather_into_tensor(out, padded.contiguous(),
                                    group=mesh.get_group(i))
        out = out.view([n] + pad)
        x = torch.cat([out[r].narrow(d, 0, sizes[r]) for r in range(n)],
                      dim=d)
    return x


def local_shard(full: torch.Tensor, like) -> torch.Tensor:
    """This rank's shard of ``full`` laid out as the DTensor ``like`` (a
    local slice, no communication), contiguous, on ``like``'s device."""
    x = full
    coords = like.device_mesh.get_coordinate()
    for i, d in _shard_dims(like):
        n = like.device_mesh.size(i)
        sizes = _chunk_sizes(x.shape[d], n)
        x = x.narrow(d, sum(sizes[:coords[i]]), sizes[coords[i]])
    return x.to(like.to_local().device).contiguous()


class _GatherLastDim(torch.autograd.Function):
    """Columns split over a tensor group -> all of them on every rank
    (``all_gather_into_tensor``); the backward takes the rank's columns of
    the gradient, which every rank holds whole."""

    @staticmethod
    def forward(ctx, x, group, size):
        import torch.distributed as dist

        n = dist.get_world_size(group)
        sizes = _chunk_sizes(size, n)
        ctx.rank_cols = (sum(sizes[:dist.get_rank(group)]), x.shape[-1])
        cols = x.movedim(-1, 0)
        padded = cols.new_zeros((sizes[0],) + tuple(cols.shape[1:]))
        padded[:cols.shape[0]] = cols
        out = cols.new_empty((n * sizes[0],) + tuple(cols.shape[1:]))
        dist.all_gather_into_tensor(out, padded, group=group)
        out = out.view((n,) + tuple(padded.shape))
        return torch.cat([out[r, :sizes[r]] for r in range(n)]).movedim(
            0, -1).contiguous()

    @staticmethod
    def backward(ctx, grad):
        start, width = ctx.rank_cols
        return grad.narrow(-1, start, width).contiguous(), None, None


class _SumGradOverGroup(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over the tensor
    group (Megatron's ``f``): a replicated input whose consumers each see
    part of the columns."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist

        grad = grad.contiguous()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def gather_columns(y: torch.Tensor, weight) -> torch.Tensor:
    """The output ``y`` of a column-parallel layer whose ``weight`` is a
    DTensor split over the vocab or the output features: every column on
    every rank, differentiable. A plain ``weight`` (no tensor parallelism)
    returns ``y``. Not DTensor's ``redistribute``: its all-gather runs
    through functional collectives, which crash with gloo on CUDA tensors
    (several ranks sharing one card, torch 2.11); the all-reduce they use
    elsewhere works."""
    from torch.distributed.tensor import DTensor

    if not isinstance(weight, DTensor):
        return y
    return _GatherLastDim.apply(y, weight.device_mesh.get_group(),
                                weight.shape[0])


def tied_logits(hidden: torch.Tensor, weight) -> torch.Tensor:
    """``hidden @ weight^T`` for the tied LM head, whose ``weight`` (the
    shared embedding) may be a DTensor split over the vocab: then each
    rank multiplies by its vocab rows, the logits are gathered, and the
    replicated ``hidden``'s gradient is summed over the tensor group."""
    import torch.nn.functional as F
    from torch.distributed.tensor import DTensor

    if not isinstance(weight, DTensor):
        return F.linear(hidden, weight)
    group = weight.device_mesh.get_group()
    local = F.linear(_SumGradOverGroup.apply(hidden, group),
                     weight.to_local())
    return _GatherLastDim.apply(local, group, weight.shape[0])


# ---------------------------------------------------------------------------
# The seq axis
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SeqGroup:
    """A seq group as a stack sees it: the process group, this rank's
    place in it and its size."""

    group: object
    rank: int
    size: int

    def split(self, length: int) -> Optional["SeqSlice"]:
        """This rank's positions of a sequence of ``length``, or None where
        the length does not divide by the group (the stack then runs whole
        on every rank), as ``seq_constraint`` is a no-op there."""
        if self.size == 1 or length % self.size:
            return None
        return SeqSlice(self.group, self.rank, self.size, length)


@dataclasses.dataclass(frozen=True)
class SeqSlice:
    """Positions ``start .. start + rows`` of a sequence of ``length``,
    split over a seq group of ``size`` ranks."""

    group: object
    rank: int
    size: int
    length: int

    @property
    def rows(self) -> int:
        return self.length // self.size

    @property
    def start(self) -> int:
        return self.rank * self.rows

    @property
    def dropout_shard(self) -> tuple[int, int]:
        """(first, total) rows: ``models.layers.dropout``'s shard."""
        return self.start, self.length


def seq_shard(x: torch.Tensor, seq: Optional[SeqSlice],
              dim: int = 1) -> torch.Tensor:
    """This rank's positions of ``x``, which it holds whole, on ``dim``
    (the JAX package's ``seq_constraint``); ``x`` itself without a slice.
    Autograd's own backward of the narrowing is the one this needs: the
    gradient of the positions the rank dropped is 0 here and arrives from
    the ranks that kept them, through the gradient all-reduce over data x
    seq."""
    if seq is None:
        return x
    return x.narrow(dim, seq.start, seq.rows)


class _SeqGather(torch.autograd.Function):
    """Every rank's positions of ``x`` on ``dim``, in rank order
    (``all_gather_into_tensor`` over the seq group); the backward sums the
    gradient over the group and hands each rank its positions' part
    (``reduce_scatter_tensor``). c10d, not the functional collectives,
    which crash with gloo on CUDA tensors."""

    @staticmethod
    def forward(ctx, x, seq, dim):
        import torch.distributed as dist

        ctx.seq, ctx.dim = seq, dim
        part = x.movedim(dim, 0).contiguous()
        out = part.new_empty((seq.size * part.shape[0],)
                             + tuple(part.shape[1:]))
        dist.all_gather_into_tensor(out, part, group=seq.group)
        return out.movedim(0, dim)

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist

        seq, dim = ctx.seq, ctx.dim
        whole = grad.movedim(dim, 0).contiguous()
        out = whole.new_empty((seq.rows,) + tuple(whole.shape[1:]))
        dist.reduce_scatter_tensor(out, whole, group=seq.group)
        return out.movedim(0, dim), None, None


def seq_gather(x: torch.Tensor, seq: Optional[SeqSlice],
               dim: int = 1) -> torch.Tensor:
    """The whole sequence from every rank's ``seq_shard`` of it on ``dim``,
    differentiable (see ``_SeqGather``); ``x`` itself without a slice."""
    if seq is None:
        return x
    return _SeqGather.apply(x, seq, dim)


# ---------------------------------------------------------------------------
# Applying the layouts
# ---------------------------------------------------------------------------


def _tensor_plan(model: nn.Module) -> dict:
    """``parallelize_module``'s plan over ``model``'s submodules, read off
    the rules: a linear whose weight has ``tensor`` on dim 0 is
    column-parallel, on dim 1 row-parallel; the shared embeddings are
    row-parallel over the vocab (replicated ids in, the all-reduced rows
    out). Column-parallel outputs stay local: a row-parallel partner
    follows q/k/v and wi, and the models gather the LM head's and the
    projections' (``gather_columns``)."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.parallel import (ColwiseParallel,
                                                   RowwiseParallel)

    plan = {}
    for name, module in model.named_modules():
        weight = getattr(module, "weight", None)
        if (not isinstance(weight, nn.Parameter)
                or not tensor_parallel(f"{name}.weight")):
            continue
        spec = spec_for_path(f"{name}.weight", weight.dim())
        if isinstance(module, nn.Embedding):
            plan[name] = RowwiseParallel(input_layouts=Replicate())
        elif spec[0] == "tensor":
            plan[name] = ColwiseParallel()
        else:
            plan[name] = RowwiseParallel()
    return plan


def _t5_stacks(model: nn.Module) -> list:
    from ..models.t5 import T5Stack

    return [m for m in model.modules() if isinstance(m, T5Stack)]


def parallelize(net: nn.Module, model: nn.Module, mesh,
                device: torch.device) -> list[nn.Module]:
    """Shard ``model`` (a ``MultiModalModel``, held by the step module
    ``net``, whose forward is the loss) over ``mesh`` (a ``utils.mesh.Mesh``
    with ``fsdp`` or ``tensor`` above 1), in place:

    1. with ``tensor`` > 1, tensor parallelism over the ``tensor`` dim of
       the ``DeviceMesh``: the T5 stacks of the text tower and the
       transformer, the LM head and the projections (``_tensor_plan``);
       each stack, attention and MLP learns its tensor rank and size, so
       that it runs its own heads and d_ff columns
       (``T5Stack.set_tensor_shard``);
    2. FSDP2 over the ``(data, fsdp)`` dims: one unit per T5 block (and
       per relative-position table), per SwinV2 stage and per tower, the
       step module last as the root, each parameter sharded on
       ``fsdp_dim``.

    The weights must be in place and equal on every rank, the frozen ones
    already in their storage dtype (a unit's parameters share one dtype).
    Returns the modules whose trainable ``weight`` has a gradient that is
    partial on each tensor rank and must be summed over the tensor group:
    the transformer's relative-position tables, of which each rank reads
    its heads' columns only. (Modules, not parameters: FSDP2 replaces the
    parameters it shards.)"""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.parallel import parallelize_module

    dmesh = mesh.device_mesh(device.type)
    partial = []
    if mesh.tensor > 1:
        parallelize_module(model, dmesh["tensor"], _tensor_plan(model))
        for stack in _t5_stacks(model):
            stack.set_tensor_shard(mesh.tensor_rank, mesh.tensor)
            if stack.relative_attention_bias.weight.requires_grad:
                partial.append(stack.relative_attention_bias)
    names = {id(p): n for n, p in model.named_parameters()}

    def placement(p: nn.Parameter):
        return Shard(fsdp_dim(names[id(p)], tuple(p.shape), mesh.fsdp))

    dp_mesh = dmesh["data", "fsdp"]
    kw = dict(mesh=dp_mesh, shard_placement_fn=placement)
    units = []
    for tower in (model.language_model, model.transformer):
        for stack in _t5_stacks(tower):
            # The relative-position table lives in block 0 (HF's names)
            # but the stack's caller reads it before any block runs: a
            # unit of its own, gathered when it is called.
            units.append(stack.relative_attention_bias)
            units.extend(stack.block)
    # A Swin stage is a container: its blocks and patch merging form one
    # unit (FSDP2 takes a list of modules as one).
    units.extend([*stage["blocks"], *([stage["downsample"]]
                                     if "downsample" in stage else [])]
                 for stage in model.image_model.encoder["layers"])
    units.extend([model.image_model, model.language_model])
    for unit in units:
        fully_shard(unit, **kw)
    fully_shard(net, **kw)
    return partial
