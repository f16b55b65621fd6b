"""The training step of the cascade, on one card or one DDP rank per card.

The port of the JAX package's ``train/trainer.py``: device-side
image normalization in the compute dtype, the frozen towers' forwards under
``torch.no_grad()``, the trainable parts' forward and backward (the
transformer, the projections and, with ``image_model_train``, the SwinV2
tower; the attention through the hand-written kernels when the kernel flags
are on; under MoE the loss includes the weighted balance loss, and with
``pipeline_stages > 1`` a microbatch's rows must divide into the
pipeline's microbatches), gradient accumulation over
``accumulation_steps`` microbatches, and the update (Adam, Adam with a
bf16 first moment, or Adafactor; ``train/optim.py``). With
``frozen_param_dtype='bfloat16'`` the frozen towers' parameters are stored
in bf16, as the JAX package's ``_maybe_cast_frozen`` stores them.

Across processes (a process group, ``utils/mesh.py``) a mesh of the data
axis alone wraps the model in ``DistributedDataParallel`` with its
gradients as views of the reducer's buckets; the frozen towers take no part.
A mesh with ``fsdp`` or ``tensor`` above 1 shards it instead
(``parallel/partitioning.py`` ``parallelize``): tensor parallelism over
``tensor``, then FSDP2 over ``(data, fsdp)``, whose gradient reduction
averages over the data x fsdp ranks as DDP's does over the world. The
ranks of one tensor group hold the same rows and compute one loss; the
relative-position tables' gradients, partial on each tensor rank (each
reads its heads' columns), are summed over the tensor group after the
backward. In what follows the "ranks" of the loss are the data x fsdp
ranks.
The loss is the JAX package's: one token-weighted mean over each global
microbatch, where global microbatch a is loader batch a of the update
across all ranks (the rank's rows [a b, (a+1) b) of its merged batch).
DDP alone would average the ranks' own means, which differ from it as soon
as the ranks hold different numbers of target tokens. So each update first
all-reduces the microbatches' token counts; a rank's microbatch loss is
scaled by its share of its global microbatch's tokens (local count / global
count / accum) and by the world size, which DDP's average divides out
again, so that the reduced gradient is the global one. Every microbatch but
the last runs under ``no_sync()``. Returned losses, training and
validation, are the all-reduced global values. The JAX package's sharding
and buffer donation have no counterpart. Under MoE the balance loss is one
mean over the global microbatch's groups, as the JAX package's: each rank's
is its share of it (``T5ForConditionalGeneration.set_aux_group``), which
takes no token share.

A mesh with ``seq`` above 1 beside ``data`` alone keeps DDP over the
world (data x seq), whose ranks hold the whole parameters: the ranks of a
seq group share their rows, and each runs its positions of every T5 stack
(``MultiModalModel.set_seq_group``). A rank's loss is the mean over its
decoder positions; its token share counts those positions' targets over
data x seq, so the all-reduced gradient is one process's. Where the target
length does not divide by ``seq`` the decoder runs whole on every seq rank
and only seq rank 0 counts its tokens. Beside ``fsdp`` or ``tensor`` the
seq ranks of one data x fsdp x tensor coordinate hold the same shards:
FSDP2 reduces each rank's gradient over data x fsdp, and the reduced
shards, each seq rank's part of the gradient of its positions, are then
summed over the seq group; token counts and losses are summed over data x
fsdp x seq (``Mesh.loss_groups``). Under MoE a seq rank's balance loss is
its positions' share of its rows' (``ops/moe.py``), and the balance
loss's mean over the rows' groups spans data x fsdp (``Mesh.dp_group``),
whose ranks hold the other rows.

A mesh with ``pipe`` or ``expert`` above 1 splits the transformer: a
pipe rank keeps its stage's blocks
(``T5ForConditionalGeneration.split_stages``), an expert rank its experts
(``split_experts``), and every rank the rest, replicated. Under MoE with
``tensor`` above 1 a rank keeps its d_ff columns of its experts too, cut
inside ``parallelize`` before FSDP2 shards the slices over data x fsdp;
under ``pipe`` with ``fsdp`` or ``tensor`` the stages are split first, and
``parallelize`` then shards the rank's stage and the rest (the stage's
blocks FSDP2 units of its data x fsdp peers; ``pipe_stages`` lets FSDP2
reduce their gradients). A pipelined transformer on several data ranks
draws its dropout masks as one process draws them for the whole batch and
keeps its rows (``T5ForConditionalGeneration.set_batch_share``).
The ranks of a pipe group, or of a tensor x expert group at one seq
coordinate, hold the same rows and positions and compute one loss: every
exchange between them sits inside the model (the stage shift, the
experts' partial sums over ``Mesh.moe_group``), so that the gradients of
the replicated parameters come out the same on each rank with no further
reduction. DDP, when there is more than one data or seq rank and nothing
is sharded, spans the data x seq group of the rank's stage or experts
(``Mesh.ddp_group``); with one data rank and one seq rank there is none.
On a partitioned mesh (sharded, or stages or banks split) the model is
built on the meta device and each rank materializes only its pieces
(``init_state``): a piece is the block of a whole state-dict entry that
the rank holds (``parallel.partitioning.rank_piece``). The same pieces
serve the whole state dicts (every rank's pieces assembled on rank 0 over
the host's gloo group) and the per-shard checkpoints
(``checkpoint/io.py``).

Dropout draws from the ``torch.Generator`` passed to each step, on the
model's device; the JAX package's dropout key becomes that generator.
"""

from __future__ import annotations

import contextlib
import dataclasses
import inspect
import itertools
from typing import Mapping, Optional, Union

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor
from torch.nn.parallel import DistributedDataParallel

from ..config import Config
from ..data.image_ops import normalize_images
from ..models.multimodal import MultiModalModel
from ..parallel.partitioning import (BANKS, ExpertGroup, PipeGroup,
                                     SeqGroup, assemble, parallelize,
                                     piece_view, rank_piece, spec_for_path,
                                     stack_layers)
from ..utils.device import resolve_device
from ..utils.mesh import Mesh, make_mesh
from ..utils.precision import get_policy
from .optim import (Adafactor, make_optimizer,
                    optimizer_groups, optimizer_state, state_piece,
                    trainable_names)

Batch = Mapping[str, Union[np.ndarray, torch.Tensor]]


class StepNet(nn.Module):
    """The loss of a batch, from its images or from cached tower features,
    as one module's forward: DDP reduces the gradients of what runs through
    its wrapper's forward. Returns (loss, the weighted balance loss that it
    includes (0 without MoE), the frozen towers' outputs or None)."""

    def __init__(self, model: MultiModalModel, compute_dtype: torch.dtype):
        super().__init__()
        self.model = model
        self.compute_dtype = compute_dtype

    def forward(self, batch: dict, generator, deterministic: bool,
                with_features: bool = False):
        if with_features:
            return self._features_then_loss(batch, generator, deterministic)
        return (*self._loss(batch, generator, deterministic), None)

    def _loss(self, batch: dict, generator, deterministic: bool):
        model = self.model
        if "image_features" in batch:
            # Cached tower features: the same loss as from the images.
            out = model.loss_from_image_features(
                batch["image_features"], batch["source_ids"],
                batch["target_ids"], source_mask=batch.get("source_mask"),
                target_mask=batch.get("target_mask"),
                language_features=batch.get("language_features"),
                deterministic=deterministic, generator=generator)
        else:
            images = normalize_images(batch["images"],
                                      dtype=self.compute_dtype)
            out = model(images, batch["source_ids"], batch["target_ids"],
                        source_mask=batch.get("source_mask"),
                        target_mask=batch.get("target_mask"),
                        deterministic=deterministic, generator=generator)
        aux = (torch.zeros((), device=out.loss.device) if out.aux_loss is None
               else self.model.config.moe_aux_loss_weight * out.aux_loss)
        return out.loss, aux

    def _features_then_loss(self, batch: dict, generator,
                            deterministic: bool):
        """(loss, (image features, language features)): the frozen towers'
        outputs surfaced for a feature cache."""
        images = normalize_images(batch["images"], dtype=self.compute_dtype)
        img = self.model.image_features(images)
        lang = self.model.language_features(batch["source_ids"],
                                            batch.get("source_mask"))
        fbatch = {k: v for k, v in batch.items() if k != "images"}
        fbatch["image_features"] = img
        fbatch["language_features"] = lang
        return (*self._loss(fbatch, generator, deterministic), (img, lang))


@dataclasses.dataclass
class Trainer:
    """Owns the model (fp32 parameters, the frozen ones in
    ``frozen_param_dtype``; compute dtype from the config's policy), the
    optimizer and its schedule. ``device``: None means the card. ``mesh``:
    None makes it from the config over the process group, if there is one
    (``utils.mesh.make_mesh``)."""

    config: Config
    num_epochs: int = 1
    device: Optional[Union[str, torch.device]] = None
    mesh: Optional[Mesh] = None

    def __post_init__(self):
        cfg = self.config
        self.device = resolve_device(self.device)
        if self.mesh is None:
            self.mesh = make_mesh(cfg.mesh_shape, cfg.mesh_axis_names,
                                  cfg.dcn_mesh_shape)
        if (self.mesh.distributed and self.device.type == "cuda"
                and self.device.index is None):
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.policy = get_policy(cfg.compute_dtype, cfg.param_dtype)
        # Partitioned, the model is built on the meta device: each rank
        # materializes its pieces only (``init_state``).
        self.model = MultiModalModel(
            cfg, dtype=self.policy.compute_dtype,
            device="meta" if self.partitioned else self.device)
        mesh = self.mesh
        # Every rank makes the groups, in one order (collectives): the
        # first call makes the ``DeviceMesh`` they all come from.
        if mesh.seq > 1:
            self.model.set_seq_group(
                SeqGroup(mesh.seq_group(self.device.type), mesh.seq_rank,
                         mesh.seq), mesh)
        if mesh.pipe > 1 and cfg.pipeline_stages != mesh.pipe:
            raise ValueError(f"mesh pipe axis {mesh.pipe} must equal "
                             f"pipeline_stages={cfg.pipeline_stages}")
        if mesh.expert > 1 and (cfg.moe_experts == 0
                                or cfg.moe_experts % mesh.expert):
            raise ValueError(f"moe_experts={cfg.moe_experts} must be a "
                             f"multiple of the mesh expert axis {mesh.expert}")
        dt = self.device.type
        self.pipe = (PipeGroup(mesh.pipe_group(dt), mesh.pipe_rank,
                               mesh.pipe) if mesh.pipe > 1 else None)
        # The banks split over tensor x expert (MoE only).
        self.expert = None
        if cfg.moe_experts and (mesh.expert > 1 or mesh.tensor > 1):
            self.expert = ExpertGroup(
                mesh.moe_group(dt), mesh.expert_rank, mesh.expert,
                mesh.tensor_rank, mesh.tensor,
                mesh.tensor_group(dt) if mesh.tensor > 1 else None,
                mesh.expert_group(dt) if mesh.expert > 1 else None)
        if mesh.split or mesh.sharded or mesh.seq > 1:
            mesh.dp_group(dt)
        if cfg.moe_experts and mesh.dp_size > 1:
            self.model.transformer.set_aux_group(mesh.dp_group(dt))
        if cfg.pipeline_stages > 1 and mesh.dp_size > 1:
            self.model.transformer.set_batch_share(mesh.dp_rank,
                                                   mesh.dp_size)
        # The whole model's state-dict names and shapes, in order, its
        # optimizer's param groups (by name) and its stacks' block counts,
        # from before any split (``init_state``).
        self._whole_names: list = []
        self._whole_shapes: dict = {}
        self._whole_groups: list = []
        self._layers: dict = {}
        self.net = StepNet(self.model, self.policy.compute_dtype)
        self.ddp: Optional[DistributedDataParallel] = None
        # Under sharding: the modules whose weights' gradients are summed
        # over the tensor group (``parallelize``).
        self.tensor_partial: list = []
        self.optimizer: Optional[torch.optim.Optimizer] = None
        self.scheduler = None
        self.step = 0

    # -- state creation ----------------------------------------------------
    def init_state(self, generator: Optional[torch.Generator] = None,
                   state_dict: Optional[Mapping[str, torch.Tensor]] = None,
                   global_batch: Optional[int] = None) -> MultiModalModel:
        """Seeded random weights (``generator``, or one seeded with
        ``config.seed`` on the device), or ``state_dict`` (for example from
        ``checkpoint.from_jax.convert_jax_params``); then a fresh optimizer
        over the trainable parameters, the frozen parameters cast to
        ``frozen_param_dtype``, and across processes the DDP wrapper.
        ``global_batch``, the rows of an update, must divide over the data
        ranks (data x fsdp).

        On a partitioned mesh (``partitioned``) the model was built on the
        meta device and this runs once (later weights come through
        ``load_full_state_dict``): the whole model's names, shapes and init
        plan are recorded, then the stages and banks are split, the frozen
        towers cast and FSDP2 and tensor parallelism applied, all on meta;
        then the rank's pieces get memory on the device (``to_empty``), the
        Swin tables are rebuilt, and each piece is filled: from
        ``state_dict``, or by the plan (``_draw_pieces``), which draws
        every parameter whole on the device, in one process's order, keeps
        the rank's piece and frees the rest before the next draw. So a rank
        holds its pieces and at most one whole parameter besides (under MoE
        a whole bank, the largest), and every layout's weights are one
        process's, bitwise on one device type. Returns the model."""
        dp = self.mesh.dp_size
        if global_batch is not None and global_batch % dp:
            raise ValueError(
                f"global batch {global_batch} not divisible by the mesh's "
                f"data factor {dp} (mesh "
                f"{dict(zip(self.mesh.axis_names, self.mesh.shape))})")
        if self.partitioned and self.optimizer is not None:
            raise RuntimeError("a sharded or split Trainer is initialized "
                               "once; load later weights with "
                               "load_full_state_dict")
        if not self.partitioned:
            if state_dict is not None:
                self.model.load_state_dict(state_dict, strict=True)
            else:
                if generator is None:
                    generator = torch.Generator(
                        device=self.device).manual_seed(self.config.seed)
                self.model.init_weights(generator)
            self._record_whole()
        else:
            self._record_whole()
            plan = list(self.model.init_plan())
            self._lay_out()
            self.net.to_empty(device=self.device)
            self.model.reset_buffers()
            if state_dict is not None:
                self.load_full_state_dict(state_dict)
            else:
                self._draw_pieces(plan, generator)
        self.optimizer, self.scheduler = make_optimizer(
            self.config, self.model, self.num_epochs)
        if self.split_model and isinstance(self.optimizer, Adafactor):
            self._spread_adafactor()
        self._cast_frozen()
        self.step = 0
        self.ddp = None
        if (self.mesh.distributed and not self.sharded
                and (not self.mesh.split
                     or self.mesh.data * self.mesh.seq > 1)):
            # Every rank builds the same weights and buffers (the same seed,
            # or the same checkpoint file): rank 0's broadcasts would only
            # repeat them, at init and before every forward.
            args = inspect.signature(
                DistributedDataParallel.__init__).parameters
            kw = dict(process_group=self.mesh.ddp_group(self.device.type),
                      gradient_as_bucket_view=True)
            kw["forward_sync_buffers" if "forward_sync_buffers" in args
               else "broadcast_buffers"] = False
            if "init_sync" in args:
                kw["init_sync"] = False
            if self.device.type == "cuda":
                kw["device_ids"] = [self.device]
            self.ddp = DistributedDataParallel(self.net, **kw)
        return self.model

    @property
    def sharded(self) -> bool:
        """Parameters sharded over fsdp or tensor (FSDP2 and tensor
        parallelism, from ``init_state`` on), not DDP."""
        return self.mesh.sharded

    @property
    def partitioned(self) -> bool:
        """Whether each rank holds part of the state (sharded, or the
        transformer's stages or experts split over ranks): the model is
        built on the meta device and each rank materializes its pieces."""
        return self.mesh.sharded or self.mesh.split

    @property
    def split_model(self) -> bool:
        """Whether the transformer's stages or MoE banks are split over
        ranks (``pipe``; ``expert``, or ``tensor`` under MoE): parts of
        the whole state live on other ranks than rank 0."""
        return self.pipe is not None or self.expert is not None

    def _record_whole(self) -> None:
        """The whole model's state-dict names and shapes, its optimizer's
        param groups and its stacks' block counts, before any split."""
        names = trainable_names(self.model, self.config)
        state = self.model.state_dict()
        self._whole_names = list(state)
        self._whole_shapes = {n: tuple(v.shape) for n, v in state.items()}
        self._whole_groups = optimizer_groups(
            self.config, [n for n, _ in self.model.named_parameters()
                          if n in names])
        self._layers = stack_layers(self._whole_names)

    def _lay_out(self) -> None:
        """On the meta device: the trainable flags, the frozen towers'
        storage dtype, the stages and banks split, then FSDP2 and tensor
        parallelism (``parallelize``, which cuts the banks itself)."""
        names = trainable_names(self.model, self.config)
        for name, p in self.model.named_parameters():
            p.requires_grad_(name in names)
        self._cast_frozen()
        if self.pipe is not None:
            self.model.transformer.split_stages(self.pipe)
        if self.sharded:
            self.tensor_partial = parallelize(self.net, self.model,
                                              self.mesh, self.device,
                                              self.expert)
        elif self.expert is not None:
            self.model.transformer.split_experts(self.expert)

    def _draw_pieces(self, plan: list, generator) -> None:
        """Run the whole model's init ``plan`` as one process runs it: each
        parameter drawn whole into a temporary on the device (fp32, as one
        process's parameters are drawn), this rank's piece copied out (and
        cast to its storage dtype), the temporary freed. A parameter the
        rank holds no piece of is drawn all the same, so that the
        generator moves as one process's does."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(
                self.config.seed)
        local = self._local_tensors()
        with torch.no_grad():
            for name, init in plan:
                t = local.get(name)
                if t is None and not init.draws:
                    continue
                whole = torch.empty(self._whole_shapes[name],
                                    dtype=torch.float32, device=self.device)
                init(whole, generator)
                if t is not None:
                    t.copy_(piece_view(whole, self.piece(name)))
                del whole

    def _local_tensors(self) -> dict:
        """{whole state-dict name: the tensor this rank holds of it (a
        DTensor's local shard)}, for the entries it holds."""
        out = {}
        for name, t in itertools.chain(self.model.named_parameters(),
                                       self.model.named_buffers()):
            if name in self._whole_shapes:
                out[name] = t.to_local() if isinstance(t, DTensor) else t
        return out

    # -- pieces ------------------------------------------------------------
    def whole_shapes(self) -> dict:
        """{state-dict name: shape} of the whole model, before any split
        (from ``init_state`` on)."""
        return dict(self._whole_shapes)

    def piece(self, name: str, rank: Optional[int] = None,
              whole_over_shards: bool = False):
        """The piece of the whole entry ``name`` that this rank (or world
        rank ``rank``) holds: ``parallel.partitioning.rank_piece`` on this
        mesh and model; the whole on one process and under DDP."""
        mesh = (self.mesh if rank is None
                else dataclasses.replace(self.mesh, rank=rank))
        return rank_piece(name, self._whole_shapes[name], mesh, self._layers,
                          self.expert is not None, whole_over_shards)

    def _state_piece(self, name: str, key: str, ndim: int,
                     rank: Optional[int] = None):
        """The piece of optimizer state entry ``key`` (``ndim`` dims) of
        parameter ``name`` that this rank (or ``rank``) holds: the
        parameter's, or with an optimizer whose state is whole over the
        shards (``Adafactor.whole_state``) the parameter's before them."""
        whole = getattr(self.optimizer, "whole_state", False)
        return state_piece(key, self._whole_shapes[name],
                           self.piece(name, rank, whole), ndim)

    def _lowest(self, piece_of, mine) -> bool:
        """Whether no lower world rank than this one holds ``mine``
        (``piece_of(rank)``): the rank that writes a piece held by several."""
        return all(piece_of(r) != mine for r in range(self.mesh.rank))

    def owned_pieces(self, model: bool = True, optimizer: bool = True,
                     names=None) -> list:
        """This rank's pieces of the whole state that no lower rank holds,
        so that over all ranks each piece of the layout comes once: a list
        of (record, this rank's tensor or None). A record is {"entry",
        "shape", "dtype", "offsets", "lengths"} (a tensor's piece) or
        {"entry", "value"} (an optimizer's plain value, a step count); the
        entries are "model/{name}" and "optimizer/{name}/{key}" (of the
        entries ``names`` only, if given). Every rank computes its own from
        the mesh and the names alone."""
        out = []

        def add(entry, shape, t, piece_of):
            piece = piece_of(None)
            if tuple(t.shape) != tuple(n for _, n in piece):
                raise RuntimeError(f"{entry}: a {tuple(t.shape)} tensor for "
                                   f"the piece {piece}")
            if t.numel() and self._lowest(piece_of, piece):
                out.append((dict(entry=entry, shape=list(shape),
                                 dtype=str(t.dtype).split(".")[-1],
                                 offsets=[o for o, _ in piece],
                                 lengths=[n for _, n in piece]), t))

        if model:
            for name, t in self._local_tensors().items():
                if names is not None and name not in names:
                    continue
                add(f"model/{name}", self._whole_shapes[name], t,
                    lambda r, n=name: self.piece(n, r))
        if not optimizer:
            return out
        by_id = {id(p): n for n, p in self.model.named_parameters()}
        for group in self.optimizer.param_groups:
            for p in group["params"]:
                name = by_id[id(p)]
                if names is not None and name not in names:
                    continue
                shape = self._whole_shapes[name]
                for key, v in self.optimizer.state.get(p, {}).items():
                    entry = f"optimizer/{name}/{key}"
                    if isinstance(v, torch.Tensor):
                        v = v.to_local() if isinstance(v, DTensor) else v
                        whole = state_piece(key, shape, tuple(
                            (0, s) for s in shape), v.dim())
                        add(entry, [s for _, s in whole], v,
                            lambda r, n=name, k=key, d=v.dim():
                            self._state_piece(n, k, d, r))
                    elif self._lowest(lambda r, n=name: self.piece(n, r)
                                      is not None, True):
                        out.append((dict(entry=entry, value=v), None))
        return out

    def _to_rank0(self, pieces: list) -> list:
        """Every rank's ``owned_pieces`` (their tensors on the host) on
        rank 0, over the host's gloo group: each rank's records as one
        pickled list, then their tensors' bytes. [] on the other ranks."""
        if not self.mesh.distributed:
            return pieces
        rank, group = self.mesh.rank, self.mesh.cpu_group
        if rank != 0:
            dist.send_object_list([[r for r, _ in pieces]], dst=0,
                                  group=group)
            for _, t in pieces:
                if t is not None:
                    dist.send(_bytes(t), dst=0, group=group)
            return []
        out = list(pieces)
        for src in range(1, dist.get_world_size(group)):
            box = [None]
            dist.recv_object_list(box, src=src, group=group)
            for rec in box[0]:
                t = None
                if "value" not in rec:
                    t = torch.empty(rec["lengths"],
                                    dtype=getattr(torch, rec["dtype"]))
                    dist.recv(_bytes(t), src=src, group=group)
                out.append((rec, t))
        return out

    def _gathered(self, model: bool, names=None) -> dict:
        """The whole entries of the model's (or the optimizer's) state (of
        ``names``, if given) on rank 0's host, from every rank's owned
        pieces; {} elsewhere."""
        pieces = [(r, None if t is None else t.detach().to("cpu", copy=True))
                  for r, t in self.owned_pieces(model=model,
                                                optimizer=not model,
                                                names=names)]
        got = self._to_rank0(pieces)
        return assemble(got) if self.mesh.rank == 0 else {}

    def _cast_frozen(self) -> None:
        if self.config.frozen_param_dtype == "bfloat16":
            # They feed bf16 compute and take no update; the buffers (window
            # masks, coordinate tables) stay fp32.
            for p in self.model.parameters():
                if not p.requires_grad and p.dtype != torch.bfloat16:
                    p.data = p.data.to(torch.bfloat16)

    # -- the pipe and expert split -----------------------------------------
    def spans_ranks(self, name: str) -> bool:
        """Whether the whole-model entry ``name`` lies in parts on
        different ranks before FSDP2's and tensor parallelism's shards: a
        pipe stage's block, or a bank cut over the tensor x expert ranks
        (``rank_piece`` without its shards differs between ranks)."""
        mine = self.piece(name, whole_over_shards=True)
        return any(self.piece(name, r, True) != mine
                   for r in range(self.mesh.layout().numel()))

    def _spread_adafactor(self) -> None:
        """Adafactor's clipping blocks whose JAX leaf spans the pipe group
        or the tensor x expert group: their sums of squares are summed over
        it (FSDP2's and a dense layer's tensor shards are gathered whole
        first, ``Adafactor._scaled``, so under ``fsdp`` or ``tensor`` too
        only the pipe ranks hold other parts of a stage's leaf). A bank is
        factored as its whole shape says, its means over the experts' dim
        taken over the expert group and over d_ff over the tensor group."""
        group = (self.pipe or self.expert).group
        names = {id(p): n for n, p in self.model.named_parameters()}
        spread = [i for i, g in enumerate(self.optimizer.param_groups)
                  if self.spans_ranks(names[id(g["params"][0])])]
        self.optimizer.spread = (group, spread)
        if self.expert is None:
            return
        for g in self.optimizer.param_groups:
            for p in g["params"]:
                n = names[id(p)]
                if n.endswith(BANKS):
                    groups = {}
                    if self.mesh.expert > 1:
                        groups[0] = self.expert.expert_group
                    if self.mesh.tensor > 1:
                        groups[self._tensor_dim(n)] = self.expert.tensor_group
                    self.optimizer.cuts[p] = (self._whole_shapes[n], groups)

    def _tensor_dim(self, name: str) -> int:
        """A bank's d_ff dim (its rule's ``tensor``)."""
        return spec_for_path(name, len(self._whole_shapes[name])).index(
            "tensor")

    # -- whole state dicts (sharded or not) --------------------------------
    def full_state_dict(self, names=None) -> dict:
        """The model's state dict with every tensor whole (of the entries
        ``names`` only, if given): its own on one process or under DDP;
        when partitioned assembled on rank 0's host from every rank's
        pieces (every rank calls it; the other ranks get an empty dict)."""
        if not self.partitioned:
            state = self.model.state_dict()
            return state if names is None else {
                n: v for n, v in state.items() if n in names}
        whole = self._gathered(model=True, names=names)
        return {n: whole[f"model/{n}"] for n in self._whole_names
                if f"model/{n}" in whole}

    def load_full_state_dict(self, state_dict: Mapping[str, torch.Tensor],
                             strict: bool = True) -> None:
        """Load a whole state dict (one process's, the same on every rank)
        into the model; when partitioned each rank copies its pieces out
        of it (no communication)."""
        if not self.partitioned:
            self.model.load_state_dict(state_dict, strict=strict)
            return
        known = set(self._whole_names)
        missing = sorted(known - set(state_dict))
        unexpected = sorted(set(state_dict) - known)
        if unexpected or (strict and missing):
            raise RuntimeError(f"state dict: missing {missing}, "
                               f"unexpected {unexpected}")
        self.load_model_pieces(
            [n for n in self._whole_names if n in state_dict],
            lambda entry, piece, out: out.copy_(piece_view(
                state_dict[entry[len("model/"):]], piece)))

    def load_model_pieces(self, names, read) -> None:
        """Fill this rank's piece of each whole entry of ``names`` in place
        with ``read("model/{name}", piece, out)``, which copies the piece's
        values into ``out`` (cast to its storage dtype)."""
        local = self._local_tensors()
        with torch.no_grad():
            for name in names:
                t = local.get(name)
                if t is not None and t.numel():
                    read(f"model/{name}", self.piece(name), t)

    def full_optimizer_state_dict(self) -> dict:
        """The optimizer's state dict (one process's form), every tensor
        whole; when partitioned assembled on rank 0 from every rank's
        pieces (every rank calls it) and {} elsewhere."""
        if not self.partitioned:
            return self.optimizer.state_dict()
        whole = self._gathered(model=False)
        if self.mesh.rank != 0:
            return {}
        hyper = {k: v for k, v in self.optimizer.param_groups[0].items()
                 if k != "params"}
        return optimizer_state(whole, self._whole_groups, hyper)

    def load_full_optimizer_state_dict(self, state: dict) -> None:
        """Load ``full_optimizer_state_dict``'s form into the optimizer:
        each rank takes its pieces of each state tensor (a sharded
        parameter's shard of Adam's moments, a bank slice's experts and
        columns; a state that ``Adafactor`` keeps whole over the shards
        whole). Every state tensor keeps its saved dtype (``AdamBf16Mu``'s
        bf16 moment)."""
        flat = [n for g in self._whole_groups for n in g]
        entries = {}
        for i, st in state["state"].items():
            for key, v in st.items():
                entries[f"optimizer/{flat[int(i)]}/{key}"] = v
        hyper = {k: v for k, v in state["param_groups"][0].items()
                 if k != "params"}
        self.load_optimizer_pieces(
            {e: (dict(shape=list(v.shape), dtype=str(v.dtype).split(".")[-1])
                 if isinstance(v, torch.Tensor) else dict(value=v))
             for e, v in entries.items()},
            lambda entry, piece, out: out.copy_(piece_view(entries[entry],
                                                           piece)), hyper)

    def load_optimizer_pieces(self, entries: Mapping[str, dict], read,
                              hyper: dict) -> None:
        """Set the optimizer's state from whole entries
        ("optimizer/{name}/{key}": {"shape", "dtype"} of a tensor, whose
        piece ``read(entry, piece, out)`` copies into ``out``, or
        {"value"}) and the param groups' hyperparameters ``hyper``. The
        state keeps its saved dtype (torch's ``load_state_dict`` would cast
        a bf16 moment to its parameter's); the old state is dropped first,
        so that device memory never holds both."""
        whole = getattr(self.optimizer, "whole_state", False)
        saved: dict = {}
        for entry, rec in entries.items():
            _, name, key = entry.split("/")
            saved.setdefault(name, {})[key] = rec
        self.optimizer.state.clear()
        for name, p in self.model.named_parameters():
            if not p.requires_grad or name not in saved:
                continue
            st = {}
            for key, rec in saved[name].items():
                if "value" in rec:
                    st[key] = rec["value"]
                    continue
                ndim = len(rec["shape"])
                piece = self._state_piece(name, key, ndim)
                # A step count stays where torch keeps it, on the host.
                v = read(f"optimizer/{name}/{key}", piece, torch.empty(
                    [n for _, n in piece], dtype=getattr(torch, rec["dtype"]),
                    device=p.device if ndim else "cpu"))
                if isinstance(p, DTensor) and not whole and ndim == p.dim():
                    v = DTensor.from_local(v, p.device_mesh, p.placements,
                                           shape=p.shape, stride=p.stride())
                st[key] = v
            self.optimizer.state[p] = st
        for g in self.optimizer.param_groups:
            g.update(hyper)

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
    def _token_counts(self, batch: dict, parts: int) -> torch.Tensor:
        """(parts,) fp32: the loss's target weights summed over each of the
        batch's ``parts`` row blocks (every position with
        ``reference_pad_quirks`` or no mask, as ``cross_entropy_loss``
        weighs them): over this rank's decoder positions under ``seq``, and
        nothing on a seq rank above 0 whose decoder runs whole."""
        ids = batch["target_ids"]
        mask = batch.get("target_mask")
        if mask is None or self.config.reference_pad_quirks:
            mask = torch.ones(ids.shape, device=ids.device)
        if self.mesh.seq > 1:
            seq = self.model.transformer.decoder.seq_slice(ids.shape[1])
            if seq is not None:
                mask = mask.narrow(1, seq.start, seq.rows)
            elif self.mesh.seq_rank:
                mask = torch.zeros_like(mask)
        return mask.reshape(parts, -1).to(torch.float32).sum(dim=1)

    def _all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over ``Mesh.loss_groups`` (data x fsdp x seq): a
        tensor, pipe or expert group holds one copy of its rows, and each
        seq rank its positions' part."""
        for group in self.mesh.loss_groups(self.device.type):
            dist.all_reduce(t, group=group)
        return t

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
        cfg = self.config
        micro = cfg.pipeline_microbatches or cfg.pipeline_stages
        if cfg.pipeline_stages > 1 and b % micro:
            raise ValueError(f"microbatch of {b} rows is not a multiple of "
                             f"pipeline_microbatches={micro}")
        self.optimizer.zero_grad(set_to_none=True)
        loss_sum = torch.zeros((), device=self.device)
        feats = []
        if self.sharded:
            loss = self._sharded_microbatches(batch, accum, b, generator,
                                              with_features, feats)
        elif self.ddp is None:
            for i in range(accum):
                mb = {k: v[i * b:(i + 1) * b] for k, v in batch.items()}
                loss, _, f = self.net(mb, generator, False, with_features)
                feats.append(f)
                loss.backward()  # sums the microbatches' gradients
                loss_sum = loss_sum + loss.detach()
            if accum > 1:
                for group in self.optimizer.param_groups:
                    for p in group["params"]:
                        if p.grad is not None:
                            p.grad.div_(accum)
            loss = loss_sum / accum
        else:
            # Each microbatch's share of its global microbatch's tokens.
            counts = self._token_counts(batch, accum)
            share = counts / (accum * self._all_reduce(counts.clone())
                              .clamp(min=1.0))
            world = self.mesh.data * self.mesh.seq
            for i in range(accum):
                mb = {k: v[i * b:(i + 1) * b] for k, v in batch.items()}
                last = i == accum - 1
                with (contextlib.nullcontext() if last
                      else self.ddp.no_sync()):
                    loss, aux, f = self.ddp(mb, generator, False,
                                            with_features)
                    part = _global_part(loss, aux, share[i], accum)
                    # DDP divides the reduced gradient by the world size.
                    (part * world).backward()
                feats.append(f)
                loss_sum = loss_sum + part.detach()
            loss = self._all_reduce(loss_sum)
        self.optimizer.step()
        self.scheduler.step()
        self.step += 1
        if with_features:
            return loss, tuple(torch.cat(parts) for parts in zip(*feats))
        return loss

    def _sharded_microbatches(self, batch: dict, accum: int, b: int,
                              generator, with_features: bool,
                              feats: list) -> torch.Tensor:
        """The microbatches' forward and backward under FSDP2 and tensor
        parallelism: the DDP branch's token shares over the data x fsdp (x
        seq) ranks, gradients reduced after the last microbatch only, then
        summed over the seq group, and the tensor-partial gradients over the
        tensor group. Returns the global loss."""
        counts = self._token_counts(batch, accum)
        share = counts / (accum * self._all_reduce(counts.clone())
                          .clamp(min=1.0))
        dp = self.mesh.dp_size
        loss_sum = torch.zeros((), device=self.device)
        for i in range(accum):
            mb = {k: v[i * b:(i + 1) * b] for k, v in batch.items()}
            self.net.set_requires_gradient_sync(i == accum - 1)
            loss, aux, f = self.net(mb, generator, False, with_features)
            part = _global_part(loss, aux, share[i], accum)
            # FSDP2 averages the reduced gradient over the dp ranks.
            (part * dp).backward()
            feats.append(f)
            loss_sum = loss_sum + part.detach()
        if self.mesh.seq > 1:
            self._sum_over_seq()
        if self.tensor_partial:
            group = self.mesh.tensor_group(self.device.type)
            for m in self.tensor_partial:
                if m.weight.grad is not None:
                    dist.all_reduce(m.weight.grad.to_local(), group=group)
        return self._all_reduce(loss_sum)

    def _sum_over_seq(self) -> None:
        """Each trainable parameter's reduced gradient shard summed over
        the seq group, in one all-reduce of them all: the seq ranks of a
        data x fsdp x tensor coordinate hold the same shards, each of the
        gradient of its own positions."""
        grads = [p.grad.to_local() if isinstance(p.grad, DTensor) else p.grad
                 for p in self.model.parameters() if p.grad is not None]
        if not grads:
            return
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=self.mesh.seq_group(self.device.type))
        for g, part in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(part.view_as(g))

    @torch.no_grad()
    def eval_step(self, batch: Batch) -> torch.Tensor:
        """Deterministic loss of ``batch``, no update (across processes:
        the token-weighted mean over every rank's rows)."""
        return self._eval(batch, with_features=False)[0]

    @torch.no_grad()
    def eval_step_with_features(self, batch: Batch):
        """``eval_step`` that also returns the frozen towers' outputs (this
        rank's rows)."""
        return self._eval(batch, with_features=True)

    def _eval(self, batch: Batch, with_features: bool):
        batch = self.to_device(batch)
        loss, aux, feats = self.net(batch, None, True, with_features)
        if self.sharded:
            # FSDP2 keeps the root unit's parameters gathered after a
            # forward (for the backward a training step runs next): shard
            # them again, so that the model holds its shards.
            self.net.reshard()
        if self.ddp is not None or self.sharded:
            n = self._token_counts(batch, 1)[0]
            ce = (loss - aux).float()
            sums = self._all_reduce(torch.stack([ce * n, n, aux.float()]))
            loss = sums[0] / sums[1].clamp(min=1.0) + sums[2]
        return loss, feats


def _global_part(loss: torch.Tensor, aux: torch.Tensor, share: torch.Tensor,
                 accum: int) -> torch.Tensor:
    """A rank's part of one global microbatch's loss: its cross-entropy
    (``loss`` less the weighted balance loss ``aux``) by its token
    ``share``, and ``aux``, already its share of the balance loss's global
    mean, over the ``accum`` microbatches."""
    return (loss - aux) * share + aux / accum


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """A host tensor's storage as a flat uint8 tensor (gloo sends bytes of
    any dtype alike)."""
    return t.contiguous().reshape(-1).view(torch.uint8)


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
