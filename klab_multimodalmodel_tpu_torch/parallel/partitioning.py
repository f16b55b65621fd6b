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
* so does the frozen text tower: it runs forward only, once a step, and
  its features feed every tensor rank whole. Split, its products at half
  the heads and columns round otherwise than one process's, and 24
  layers amplify those last-bit differences into features that differ
  from one process's across most elements (t5-large on an H100, bf16),
  which then move the MoE routing of the transformer; whole, it runs as
  one process's. FSDP2 still shards it over ``fsdp``;
* FSDP2 shards every parameter, also those the rules replicate (norms,
  relative-position tables, the Swin position-bias MLP): those go on dim
  0, as does any parameter whose rule's ``fsdp`` dim does not divide by
  the axis (``fsdp_dim``). Numerics do not depend on the dim; per-rank
  bytes do.

The ``seq`` axis replicates every parameter, as ``data`` does: beside
``fsdp`` and ``tensor`` the seq ranks of one data x fsdp x tensor
coordinate hold the same shards, and the trainer sums their reduced
gradients over the seq group. Its ranks split the positions of each T5
stack (``SeqSlice``): ``seq_shard`` is the port of the JAX package's
``seq_constraint``, ``seq_gather`` the all-gather that XLA inserts for
attention's keys and values (and the reduce-scatter of their gradient).

The ``pipe`` and ``expert`` axes replicate every parameter but the
transformer's stage blocks and expert banks. ``stage_for_path`` is the JAX
``_with_pipe`` rule on the port's names (block i of a stack of L lies in
stage ``i // (L / S)``; the relative-position tables, which the JAX
package keeps outside its stacks, on every stage), and the ``expert``
rule shards the banks' leading dim. The JAX package's three constraints
become the exchanges XLA would insert for them:

* ``expert_constraint``: ``ExpertGroup``, the ranks that share the rows
  (and positions, under ``seq``) and split the banks: tensor x expert. No
  token moves. Each rank runs its
  experts' FFN on its ``d_ff / tensor`` columns of each (``wi`` cut on
  dim 2, ``wo`` on dim 1, where the rules put ``tensor``), and Megatron's
  f and g carry the partial results: the token activations' gradient is
  summed over tensor x expert (``expert_enter``), the experts' outputs
  over the tensor group (their d_ff columns), and the combine and the
  combine weights' gradient over the expert group (``expert_exit``);
* ``pipe_constraint``: ``PipeGroup`` and ``pipe_stages``, the stage shift
  (each microbatch sent to the next stage, the cotangent received back);
* ``tick_constraint``: the microbatch rows of the tick stack are this data
  rank's own rows (``pipe_stages`` splits them; its backward puts each
  microbatch's gradient back in place).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import re
from typing import Callable, Iterable, Mapping, Optional, Sequence

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
    ``pipe`` axis is not a dim of the port's parameters (each block keeps
    its own): ``stage_for_path`` places them."""
    for pattern, trailing in _RULES:
        if re.search(pattern, name):
            if len(trailing) > ndim:
                return (None,) * ndim
            return (None,) * (ndim - len(trailing)) + tuple(trailing)
    return (None,) * ndim


# A block's parameter in one of the transformer's stacks: (stack, index).
_STAGE_BLOCK = re.compile(
    r"^(?:transformer\.)?(encoder|decoder)\.block\.(\d+)\.(.*)$")


def stage_for_path(name: str, num_layers: Mapping[str, int],
                   stages: int) -> Optional[int]:
    """The pipeline stage that holds the transformer parameter ``name``,
    or None where every stage holds it: the JAX ``_with_pipe`` rule, which
    shards the leading stage axis of the pipelined stacks over ``pipe``.
    Block i of a stack of ``num_layers[stack]`` blocks ('encoder',
    'decoder') lies in stage ``i // (L / stages)``; the relative-position
    table (HF's name puts it in block 0) is outside the JAX package's
    stacks and on every stage, and so is everything outside the blocks."""
    m = _STAGE_BLOCK.match(name)
    if stages == 1 or m is None or "relative_attention_bias" in m.group(3):
        return None
    L = num_layers[m.group(1)]
    if L % stages:
        raise ValueError(f"num_layers={L} not divisible by "
                         f"pipeline_stages={stages}")
    return int(m.group(2)) // (L // stages)


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
    SwinV2 tower's or the text tower's (replicated by design)."""
    if name.startswith(("image_model.", "language_model.")):
        return False
    return "tensor" in spec_for_path(name, 4)


# ---------------------------------------------------------------------------
# Per-rank bytes
# ---------------------------------------------------------------------------


def applied_spec(name: str, shape: tuple, axis_sizes: Mapping[str, int]
                 ) -> tuple:
    """The mesh axes on each dim as ``parallelize`` and the expert split
    lay a parameter out: ``expert`` and ``tensor`` where the rules put them
    (``tensor`` not on the Swin tower; a bank's d_ff), ``fsdp`` on
    ``fsdp_dim`` (whose dim, where the rule names one, no other axis cuts,
    so the whole shape decides it as the rank's does). Entries are tuples
    of axis names."""
    spec = spec_for_path(name, len(shape))
    out = [[] for _ in shape]
    if "expert" in spec and axis_sizes.get("expert", 1) > 1:
        out[spec.index("expert")].append("expert")
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
                   moment_bytes: int = 8, pipe_rank: int = 0
                   ) -> dict[str, int]:
    """Bytes of parameters (fp32), gradients (fp32) and Adam's two fp32
    moments (``moment_bytes`` per element) on one rank, for parameters
    given as (name, shape, trainable) and laid out as ``parallelize`` and
    the expert split lay them over ``axis_sizes``; with ``pipe`` above 1
    only the blocks of stage ``pipe_rank`` (``stage_for_path``) count.
    ``data`` and ``seq`` replicate, so their sizes change nothing.
    Frozen parameters have no gradient and no moments."""
    named_shapes = list(named_shapes)
    stages = axis_sizes.get("pipe", 1)
    layers = stack_layers(n for n, _, _ in named_shapes)
    params = grads = moments = 0
    for name, shape, trainable in named_shapes:
        if stages > 1 and stage_for_path(name, layers, stages) not in (
                None, pipe_rank):
            continue
        n = shard_numel(shape, applied_spec(name, shape, axis_sizes),
                        axis_sizes)
        params += 4 * n
        if trainable:
            grads += 4 * n
            moments += moment_bytes * n
    return dict(params=params, grads=grads, moments=moments,
                total=params + grads + moments)


def stack_layers(names: Iterable[str]) -> dict[str, int]:
    """{'encoder' / 'decoder': its block count} of the transformer's
    stacks, read off parameter names (one past the largest index)."""
    out: dict[str, int] = {}
    for name in names:
        m = _STAGE_BLOCK.match(name)
        if m is not None:
            out[m.group(1)] = max(out.get(m.group(1), 0),
                                  int(m.group(2)) + 1)
    return out


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


# ---------------------------------------------------------------------------
# A rank's piece of a whole tensor
# ---------------------------------------------------------------------------

# (offset, length) on every dim of a whole tensor: the block a rank holds.
Piece = tuple

# MoE expert banks (``T5MoeMlp``): cut on their experts and d_ff.
BANKS = (".mlp.experts_wi", ".mlp.experts_wo")


def _chunk(span: tuple[int, int], n: int, k: int) -> tuple[int, int]:
    """Chunk ``k`` of ``n`` (``torch.chunk``'s sizes) of ``span``."""
    sizes = _chunk_sizes(span[1], n)
    return span[0] + sum(sizes[:k]), sizes[k]


def rank_piece(name: str, shape: tuple, mesh, layers: Mapping[str, int],
               banks: bool, whole_over_shards: bool = False
               ) -> Optional[Piece]:
    """The piece of the whole-model state-dict entry ``name`` (of the
    whole ``shape``) that rank ``mesh.rank`` of ``mesh`` (a
    ``utils.mesh.Mesh``) holds, or None where it holds none. The rules
    that lay the model out, in the order ``parallelize`` and the split
    apply them:

    1. the pipe stage (``stage_for_path`` over the stacks' block counts
       ``layers``): another stage's block is held by none of this stage's
       ranks;
    2. under MoE with split banks (``banks``: tensor or expert above 1) a
       bank's experts on dim 0 and its d_ff columns (``ExpertGroup``);
    3. else tensor parallelism over ``tensor`` where ``tensor_parallel``
       says (DTensor's ``Shard``: ``torch.chunk``'s sizes);
    4. FSDP2 over ``fsdp`` on ``fsdp_dim`` (``torch.chunk``'s sizes, of
       what the earlier rules left), on a sharded mesh.

    ``whole_over_shards`` leaves out 3 and 4: the piece of a state that
    is whole over the shards (``Adafactor``'s). A chunk past the end of a
    dim is a piece of length 0. Every rank can compute every rank's
    pieces: ``dataclasses.replace(mesh, rank=r)``."""
    piece = [(0, n) for n in shape]
    if mesh.pipe > 1:
        stage = stage_for_path(name, layers, mesh.pipe)
        if stage is not None and stage != mesh.pipe_rank:
            return None
    spec = spec_for_path(name, len(shape))
    tensor_dim = None
    if banks and name.endswith(BANKS):
        per = shape[0] // mesh.expert
        piece[0] = (mesh.expert_rank * per, per)
        td = spec.index("tensor")
        per = shape[td] // mesh.tensor
        piece[td] = (mesh.tensor_rank * per, per)
    elif (mesh.tensor > 1 and tensor_parallel(name)
          and not whole_over_shards):
        tensor_dim = spec.index("tensor")
        piece[tensor_dim] = _chunk(piece[tensor_dim], mesh.tensor,
                                   mesh.tensor_rank)
    if mesh.sharded and shape and not whole_over_shards:
        d = fsdp_dim(name, shape, mesh.fsdp)
        if d == tensor_dim:
            raise NotImplementedError(
                f"{name} {shape}: fsdp and tensor on one dim")
        piece[d] = _chunk(piece[d], mesh.fsdp, mesh.dp_rank % mesh.fsdp)
    return tuple(piece)


def piece_view(t: torch.Tensor, piece: Piece,
               within: Optional[Piece] = None) -> torch.Tensor:
    """The view of ``piece`` in ``t``, which holds the whole tensor, or
    the piece ``within`` of it."""
    for d, (start, length) in enumerate(piece):
        t = t.narrow(d, start - (within[d][0] if within else 0), length)
    return t


def overlap(a: Piece, b: Piece) -> Optional[Piece]:
    """The block two pieces of one tensor share, or None."""
    out = []
    for (s0, n0), (s1, n1) in zip(a, b):
        start, stop = max(s0, s1), min(s0 + n0, s1 + n1)
        if stop <= start:
            return None
        out.append((start, stop - start))
    return tuple(out)


def record_piece(record: Mapping) -> Piece:
    """The piece of a piece record ({"offsets", "lengths"})."""
    return tuple(zip(record["offsets"], record["lengths"]))


def assemble(pieces: Iterable[tuple[Mapping, Optional[torch.Tensor]]]
             ) -> dict:
    """{entry: its whole tensor on the host, or its plain value} from
    (record, tensor) pairs (``Trainer.owned_pieces``' records: "entry",
    "shape", "dtype" and the piece, or "entry" and "value"). Raises where
    the pieces do not fill an entry exactly."""
    out: dict = {}
    filled: dict = {}
    for rec, t in pieces:
        entry = rec["entry"]
        if "value" in rec:
            out.setdefault(entry, rec["value"])
            continue
        whole = out.get(entry)
        if whole is None:
            whole = out[entry] = torch.empty(
                rec["shape"], dtype=getattr(torch, rec["dtype"]))
        piece_view(whole, record_piece(rec)).copy_(t)
        filled[entry] = filled.get(entry, 0) + t.numel()
    for entry, n in filled.items():
        if n != out[entry].numel():
            raise RuntimeError(f"{entry}: pieces of {n} elements for a "
                               f"{tuple(out[entry].shape)} tensor")
    return out


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
# The expert axis
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ExpertGroup:
    """The ranks that split an MoE layer's banks, as the layer sees them:
    ``group``, the process group of tensor x expert (the ranks that share
    the rows and, under ``seq``, the positions), this rank's place on the
    expert axis (``rank`` of ``size``,
    whose ranks ``expert_group`` holds) and on the tensor axis
    (``tensor_rank`` of ``tensor``, in ``tensor_group``). Rank (t, e)
    holds experts ``[e E / size, (e + 1) E / size)`` of every layer's E,
    and columns ``[t F / tensor, (t + 1) F / tensor)`` of their d_ff. A
    group of one rank is None."""

    group: object
    rank: int
    size: int
    tensor_rank: int = 0
    tensor: int = 1
    tensor_group: object = None
    expert_group: object = None

    def experts(self, num_experts: int) -> slice:
        """This rank's experts of ``num_experts``."""
        if num_experts % self.size:
            raise ValueError(f"moe_experts={num_experts} must be divisible "
                             f"by the mesh expert axis {self.size}")
        per = num_experts // self.size
        return slice(self.rank * per, (self.rank + 1) * per)

    def columns(self, d_ff: int) -> slice:
        """This rank's columns of a d_ff of ``d_ff``."""
        if d_ff % self.tensor:
            raise ValueError(f"d_ff={d_ff} must divide by the mesh tensor "
                             f"axis {self.tensor}")
        per = d_ff // self.tensor
        return slice(self.tensor_rank * per, (self.tensor_rank + 1) * per)


class _SumOverGroup(torch.autograd.Function):
    """Forward: the sum over the group (``all_reduce``); backward: the
    identity (Megatron's ``g``): a partial result whose every rank's
    consumers see the whole, so the gradient, the same on every rank, is
    each part's."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def sum_over_group(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group`` (``all_reduce``, Megatron's ``g``: the
    backward hands every rank the gradient as it is)."""
    return _SumOverGroup.apply(x, group)


def grad_summed_over(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` itself, whose gradient the backward sums over ``group``
    (Megatron's ``f``); ``x`` without a group."""
    if group is None:
        return x
    return _SumGradOverGroup.apply(x, group)


def expert_enter(x: torch.Tensor, expert: Optional[ExpertGroup]
                 ) -> torch.Tensor:
    """``x``, the token activations (replicated over the group), as they
    enter the rank's experts: the identity, whose backward sums the
    gradient over tensor x expert (each rank's part comes from its experts
    and columns only). ``x`` itself without a group."""
    return grad_summed_over(x, None if expert is None else expert.group)


def expert_exit(y: torch.Tensor, expert: Optional[ExpertGroup]
                ) -> torch.Tensor:
    """The rank's partial combine (its experts' share of each token's
    output) summed over the expert group; the backward hands every rank
    the gradient as it is. ``y`` itself without an expert group."""
    if expert is None or expert.expert_group is None:
        return y
    return _SumOverGroup.apply(y, expert.expert_group)


# ---------------------------------------------------------------------------
# The pipe axis
# ---------------------------------------------------------------------------

# Stage shifts made by this process, each way (the counter a run reads to
# see that activations and cotangents travelled between stages).
shifts = 0


@dataclasses.dataclass(frozen=True)
class PipeGroup:
    """A pipe group as a pipelined stack sees it: the process group, this
    rank's place in it (the stage it runs) and its size (the stages)."""

    group: object
    rank: int
    size: int

    def _peer(self, step: int) -> int:
        import torch.distributed as dist

        return dist.get_global_rank(self.group, self.rank + step)

    def _staged(self, t: torch.Tensor) -> bool:
        """Gloo takes no CUDA tensor for point-to-point
        (``tools/torch_gloo_cuda_probe.py``): such a shift goes through
        host memory."""
        import torch.distributed as dist

        return t.is_cuda and dist.get_backend(self.group) == "gloo"

    def send(self, t: torch.Tensor, step: int) -> tuple:
        """Start sending ``t`` to stage ``rank + step``; returns what
        ``wait`` takes (the request and the buffer it reads)."""
        import torch.distributed as dist

        global shifts
        buf = t.detach().contiguous()
        if self._staged(buf):
            buf = buf.cpu()
        shifts += 1
        return dist.isend(buf, self._peer(step), group=self.group), buf

    def recv(self, like: torch.Tensor, shape: Sequence[int],
             step: int) -> torch.Tensor:
        """A tensor of ``shape`` (``like``'s dtype and device) from stage
        ``rank + step``."""
        import torch.distributed as dist

        buf = torch.empty(tuple(shape), dtype=like.dtype, device=(
            "cpu" if self._staged(like) else like.device))
        dist.recv(buf, self._peer(step), group=self.group)
        return buf.to(like.device)

    @staticmethod
    def wait(sent: list) -> None:
        for req, _ in sent:
            req.wait()

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the group, in place."""
        import torch.distributed as dist

        dist.all_reduce(t, group=self.group)
        return t


def tick_stack(t: Optional[torch.Tensor], M: int) -> list:
    """The JAX ``tick_constraint``'s stack on one data rank: its rows of
    ``t`` as M microbatches (None for each where ``t`` is None)."""
    if t is None:
        return [None] * M
    rows = t.shape[0] // M
    return [t[m * rows:(m + 1) * rows] for m in range(M)]


# One stage's run of microbatch m: (m, x, head bias, enc_out rows, key mask
# rows, cross key mask rows) -> the stage's output rows.
StageFn = Callable[..., torch.Tensor]


def _stage_forward(stage_fn: StageFn, pipe: PipeGroup, M: int, grad: bool,
                   x, head_bias, enc_out, kmask, cross_kmask,
                   needs: Sequence[bool]):
    """The forward of ``pipe_stages`` on this stage: (the last stage's
    outputs on every rank, each microbatch's input leaf and output)."""
    first, last = pipe.rank == 0, pipe.rank == pipe.size - 1
    hb, eo = (None if t is None else t.detach().requires_grad_(grad and n)
              for t, n in ((head_bias, needs[1]), (enc_out, needs[2])))
    xs, ys, sent = [], [], []
    graph = torch.enable_grad() if grad else contextlib.nullcontext()
    with graph:
        # Sliced in the graph: each microbatch's share of the gradient.
        eos = tick_stack(eo, M)
    parts = zip(tick_stack(x, M), eos, tick_stack(kmask, M),
                tick_stack(cross_kmask, M))
    for m, (xm, eom, km, ckm) in enumerate(parts):
        if not first:
            xm = pipe.recv(x, xm.shape, -1)
        with graph:
            xm = xm.detach().requires_grad_(grad and (needs[0]
                                                      or not first))
            y = stage_fn(m, xm, hb, eom, km, ckm)
        xs.append(xm)
        ys.append(y)
        if not last:
            sent.append(pipe.send(y, 1))
    PipeGroup.wait(sent)
    out = torch.cat([y.detach() for y in ys]) if last else torch.zeros_like(x)
    # The last stage's outputs on every rank (the others add zeros).
    return pipe.sum(out), xs, ys, hb, eo


def _fsdp_units(modules: Sequence[nn.Module]) -> list:
    """The FSDP2 units among ``modules`` (none without FSDP2)."""
    from torch.distributed.fsdp import FSDPModule

    return [m for m in modules if isinstance(m, FSDPModule)]


def _syncs_gradients(unit) -> bool:
    """Whether FSDP2 reduce-scatters the FSDP2 unit ``unit``'s gradients
    after its next backward (what ``set_requires_gradient_sync`` last set:
    FSDP2 has no getter for it)."""
    state = unit._get_fsdp_state()
    groups = getattr(state, "_fsdp_param_groups", None)
    if groups is None:  # torch 2.11: one group a unit
        groups = [g for g in (state._fsdp_param_group,) if g is not None]
    return all(g.reduce_grads for g in groups)


class _PipeStages(torch.autograd.Function):
    """The GPipe schedule across a pipe group, with its backward written
    out: each microbatch's activations shifted to the next stage in the
    forward and its cotangent shifted back in the backward, in the same
    microbatch order on both ends of every shift (point-to-point has no
    autograd). The gradients of the inputs that every stage reads (the
    head bias, the encoder output) and of ``x`` (which only stage 0
    reads) are partial on each rank and are summed over the group; the
    stage's parameters' gradients are its own.

    Plain parameters (one rank a stage, or DDP over the data group) get
    their gradients back from the Function, summed over the microbatches.
    FSDP2 units (``fsdp`` or ``tensor`` above 1) cannot: the forward read
    the units' unsharded parameters, which autograd does not link to the
    sharded ones the Function takes. Their backward accumulates each
    microbatch's gradients into those unsharded parameters, as a plain
    backward would, with the reduce-scatter off; the last microbatch's
    backward turns it back on where the step had it on (under gradient
    accumulation only the step's last microbatch syncs), so FSDP2 reduces
    the stage's gradients once, into the sharded parameters' ``.grad``, and
    reshards each unit after each microbatch's backward (the pattern of
    ``torch.distributed.pipelining``'s ``backward_maybe_with_nosync``)."""

    @staticmethod
    def forward(ctx, stage_fn, pipe, M, units, x, head_bias, enc_out, kmask,
                cross_kmask, *params):
        needs = ctx.needs_input_grad[4:7]
        out, ctx.xs, ctx.ys, ctx.hb, ctx.eo = _stage_forward(
            stage_fn, pipe, M, True, x, head_bias, enc_out, kmask,
            cross_kmask, needs)
        ctx.pipe, ctx.params, ctx.needs = pipe, params, needs
        ctx.units = units
        ctx.x_like = (x.shape, x.dtype, x.device)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        pipe, units = ctx.pipe, ctx.units
        # FSDP2's parameters take their gradients from its own hooks.
        params = [] if units else ctx.params
        first, last = pipe.rank == 0, pipe.rank == pipe.size - 1
        leaves = [t for t in (ctx.hb, ctx.eo)
                  if t is not None and t.requires_grad]
        p_grads = [None] * len(params)
        l_grads = [None] * len(leaves)
        x_grads, sent = {}, []
        M = len(ctx.ys)
        g_parts = tick_stack(grad_out, M)
        sync = [_syncs_gradients(u) for u in units]
        for m in reversed(range(M)):
            y, xm = ctx.ys[m], ctx.xs[m]
            g = g_parts[m] if last else pipe.recv(y, y.shape, 1)
            if units:
                for unit, on in zip(units, sync):
                    unit.set_requires_gradient_sync(on and m == 0,
                                                    recurse=False)
                # Into the .grad of xm, the leaves (summed over the
                # microbatches) and the units' unsharded parameters.
                torch.autograd.backward(y, g)
                gs = [xm.grad] if xm.requires_grad else []
            else:
                inputs = ([xm] if xm.requires_grad else []) + leaves + list(
                    params)
                gs = list(torch.autograd.grad(y, inputs, g,
                                              allow_unused=True))
            if xm.requires_grad:
                gx = gs.pop(0)
                gx = torch.zeros_like(xm) if gx is None else gx
                if first:
                    x_grads[m] = gx
                else:
                    sent.append(pipe.send(gx, -1))
            for acc, new in ((l_grads, gs[:len(leaves)]),
                             (p_grads, gs[len(leaves):])):
                for i, gi in enumerate(new):
                    if gi is not None:
                        acc[i] = gi if acc[i] is None else acc[i] + gi
            ctx.ys[m] = ctx.xs[m] = None
        if units:
            l_grads = [t.grad for t in leaves]
        PipeGroup.wait(sent)
        shape, dtype, device = ctx.x_like
        gx = None
        if ctx.needs[0]:
            gx = (torch.cat([x_grads[m] for m in range(M)]) if first
                  else torch.zeros(shape, dtype=dtype, device=device))
            pipe.sum(gx)
        summed = {id(t): pipe.sum(torch.zeros_like(t) if g is None else g)
                  for t, g in zip(leaves, l_grads)}
        g_hb, g_eo = (None if t is None else summed.get(id(t))
                      for t in (ctx.hb, ctx.eo))
        if units:
            p_grads = [None] * len(ctx.params)
        return (None, None, None, None, gx, g_hb, g_eo, None, None,
                *p_grads)


def pipe_stages(stage_fn: StageFn, modules: Sequence[nn.Module],
                pipe: PipeGroup, M: int, x: torch.Tensor,
                head_bias: Optional[torch.Tensor],
                enc_out: Optional[torch.Tensor],
                kmask: Optional[torch.Tensor],
                cross_kmask: Optional[torch.Tensor]) -> torch.Tensor:
    """The GPipe schedule with stage ``pipe.rank`` on this rank (the JAX
    ``pipe_constraint``): microbatch m (``tick_stack``'s rows of ``x`` and
    of its masks and encoder context) goes through ``stage_fn`` once the
    previous stage has shifted it here, and on to the next. Stage s runs
    microbatch m at tick s + m, as one process runs the ticks. Returns
    the last stage's outputs, in batch order, on every rank of the group.
    ``modules``: the stage's blocks. Their trainable parameters' gradients
    the backward returns (DDP over the data group sees each once), or,
    where the blocks are FSDP2 units, leaves to FSDP2 (``_PipeStages``)."""
    if not torch.is_grad_enabled():
        return _stage_forward(stage_fn, pipe, M, False, x, head_bias,
                              enc_out, kmask, cross_kmask,
                              (False,) * 3)[0]
    params = [p for m in modules for p in m.parameters() if p.requires_grad]
    return _PipeStages.apply(stage_fn, pipe, M, _fsdp_units(modules), x,
                             head_bias, enc_out, kmask, cross_kmask, *params)


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
                device: torch.device,
                expert: Optional[ExpertGroup] = None) -> list[nn.Module]:
    """Shard ``model`` (a ``MultiModalModel``, held by the step module
    ``net``, whose forward is the loss) over ``mesh`` (a ``utils.mesh.Mesh``
    with ``fsdp`` or ``tensor`` above 1), in place:

    1. with ``tensor`` > 1, tensor parallelism over the ``tensor`` dim of
       the ``DeviceMesh``: the transformer's T5 stacks (under ``pipe``, the
       blocks of the rank's stage: the split comes first), its LM head and
       the projections (``_tensor_plan``); each stack, attention and MLP
       learns its tensor rank and size, so that it runs its own heads and
       d_ff columns (``T5Stack.set_tensor_shard``);
    2. under MoE with ``expert`` (the tensor x expert group), the banks cut
       to the rank's experts and d_ff columns
       (``T5ForConditionalGeneration.split_experts``);
    3. FSDP2 over the ``(data, fsdp)`` dims: one unit per T5 block (and
       per relative-position table), per SwinV2 stage and per tower, the
       step module last as the root, each parameter sharded on
       ``fsdp_dim`` of its shape on the rank (a bank's cut one). Under
       ``pipe`` the units are the blocks of the rank's stage: the places of
       the other stages' blocks (``models.t5._Elsewhere``, and block 0's
       table on its own, ``_TableOnly``) hold no parameter of their own
       and become no unit; the table is a unit on every pipe rank.

    The banks stay plain tensors, local slices with explicit partial sums
    (``ExpertGroup``), not DTensors over ``tensor`` and ``expert``: the
    dispatch and combine einsums have no DTensor sharding rule that keeps
    the experts' dim local, and the sums that XLA inserts for
    ``expert_constraint`` are then one all-reduce per MoE layer over c10d
    (DTensor's functional collectives crash with gloo on CUDA tensors).
    FSDP2 sees each slice as a tensor replicated over its data x fsdp
    group, and shards it there.

    The model is on the meta device (``Trainer.init_state`` then gives
    each rank's pieces memory and fills them), or holds the same weights
    on every rank; the frozen ones already in their storage dtype (a
    unit's parameters share one dtype).
    Returns the modules whose trainable ``weight`` has a gradient that is
    partial on each tensor rank and must be summed over the tensor group:
    the transformer's relative-position tables, of which each rank reads
    its heads' columns only. (Modules, not parameters: FSDP2 replaces the
    parameters it shards.)"""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.parallel import parallelize_module

    from ..models.t5 import T5Block

    dmesh = mesh.device_mesh(device.type)
    partial = []
    if mesh.tensor > 1:
        parallelize_module(model, dmesh["tensor"], _tensor_plan(model))
        for stack in _t5_stacks(model.transformer):
            stack.set_tensor_shard(mesh.tensor_rank, mesh.tensor)
            if stack.relative_attention_bias.weight.requires_grad:
                partial.append(stack.relative_attention_bias)
    if expert is not None:
        model.transformer.split_experts(expert)
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
            units.extend(b for b in stack.block if isinstance(b, T5Block))
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
