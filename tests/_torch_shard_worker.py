"""One rank of a sharded training job of the port on the CPU (gloo), for
the tests of FSDP2, tensor and sequence parallelism:

    python -m torch.distributed.run --nproc_per_node W \\
        tests/_torch_shard_worker.py SPEC.json

SPEC.json holds the tiny geometries to register (as
``_torch_ddp_worker.py`` reads them) and ``runs``, one after another in
the one process group. A run is a dict of ``config`` (``Config`` fields,
its ``mesh_shape`` the layout), ``init`` (a ``.pt`` state dict every rank
loads) or ``pretrained`` (a ``save_pretrained`` directory that every rank
loads through ``load_pretrained_params`` over its seeded weights), or
neither (the seeded weights), optionally ``resume`` (a checkpoint
directory's ``result_dir`` whose latest checkpoint the run restores
before its steps, each rank writing to ``reads`` (with ``{rank}``) the
files it read and the files its pieces overlap; rank 0's whole state
then held goes into ``params`` as ``resumed`` and ``resumed_optimizer``),
``batches`` (a ``.pt`` list of global batches; each data rank
takes its rows), ``result_dir`` (its checkpoint ``step_N`` is written
there), ``out`` (rank 0's JSON: the losses), ``params`` (rank 0's ``.pt``:
the whole parameters gathered after the steps, and the whole optimizer
state as ``optimizer``) and optionally ``local`` (a ``.pt`` path with
``{rank}``: each rank's own shards of the parameters that no tensor rank
splits, and of the MoE banks; all of them without a tensor axis),
``held`` (a ``.json`` path with ``{rank}``: the bytes of the parameters
the rank holds, 4 an element, and its ``DeviceMesh`` coordinate) and
``restore`` (a checkpoint
directory's ``result_dir`` whose ``step_N`` this run restores after its
steps; rank 0 writes the whole parameters and optimizer state then held
to ``restored`` and ``restored_optimizer``) and ``one_stream`` (every
data rank draws its dropout from data rank 0's generator, not its own). The JSON holds the stage
shifts of the steps too, and the size of DDP's group (0 without DDP). A run with
``loop`` instead runs ``train()`` on the skewed synthetic rows of
``_torch_ddp_worker.loaders`` (``n_train``, ``n_val``, ``global_batch``),
each data rank on its chunk, and rank 0 writes its losses to ``out``
and each rank its parameters to ``params`` (with ``{rank}``; under
sharding rank 0's are the whole ones, gathered, and the others' none);
with ``eval`` (a ``.pt`` list of global batches) the trained model's
``eval_step`` losses go into ``out`` too, and so does the count of the
ring's exchanges in the steps. A run with ``ring`` calls
``ring_self_attention`` alone: ``inputs`` (a ``.pt`` of whole q, k, v,
bias, the output's cotangent ``ct``, ``rate`` and ``seed``) split over
``layout`` = (data, seq) with seq groups of consecutive ranks (a layout
smaller than the world repeats over the rest), and each rank writes its
rows of the output and of dq, and its chunks of dk, dv, and its rows of
the bias gradient, to ``out`` (with ``{rank}``), with the ring's
exchanges. A run with ``stack`` runs a pipelined T5 decoder stack alone
under FSDP2: ``inputs`` (a ``.pt`` of its ``size`` fields, ``layers``,
``microbatches``, ``state``, whole ``x``, ``enc_out``, masks, the
output's cotangent ``ct``, ``rate`` and ``seed``) on ``layout``, the
stages split over pipe and every block and the relative-position table
an FSDP2 unit of the data x fsdp ranks, which take their rows; each rank
writes to ``out`` (with ``{rank}``) the gradients of the parameters it
holds (whole, gathered, and its shards), whether each unit holds only
its shards after the step, and the gradients of its rows of the inputs.
A run with ``init_check`` runs ``init_state`` alone on a generator seeded
with ``seed`` under an ``AllocationWatch`` and writes each rank's pieces,
buffers, generator state and the watch's readings to ``out`` (with
``{rank}``); a run with ``interrupt`` (a rank) saves a checkpoint, then a
second one whose shard write dies on that rank, and each rank writes to
``out`` (with ``{rank}``) what ``wait()`` raised and ``latest()``; then a
third whose ranks exit once it is in place, with no ``wait()``.
Needs no JAX.
"""

import json
import os
import time
import weakref

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode

from _torch_ddp_worker import loaders, read_spec
from klab_multimodalmodel_tpu_torch import config as tcfg
from klab_multimodalmodel_tpu_torch.checkpoint.io import (
    CheckpointManager, PieceReader, load_pretrained_params)
from klab_multimodalmodel_tpu_torch.ops import ring_attention
from klab_multimodalmodel_tpu_torch.parallel import partitioning
from klab_multimodalmodel_tpu_torch.parallel.partitioning import (
    SeqGroup, overlap, record_piece, tensor_parallel)
from klab_multimodalmodel_tpu_torch.train import Trainer, train
from klab_multimodalmodel_tpu_torch.train.loop import dropout_seed
from klab_multimodalmodel_tpu_torch.utils.mesh import (make_mesh,
                                                      maybe_init_distributed)


# MoE banks: plain slices of the rank's experts and columns, never
# DTensors over tensor.
BANKS = (".mlp.experts_wi", ".mlp.experts_wo")


def rows(batch: dict, mesh) -> dict:
    """This data rank's chunk of a global batch."""
    n = next(iter(batch.values())).shape[0] // mesh.dp_size
    lo = mesh.dp_rank * n
    return {k: v[lo:lo + n] for k, v in batch.items()}


def run_ring(run: dict) -> None:
    """``ring_self_attention`` on this rank's part of whole inputs, and its
    gradients (see the module doc)."""
    data, S = run["layout"]
    rank, world = dist.get_rank(), dist.get_world_size()
    group, _ = dist.new_subgroups_by_enumeration(
        [list(range(i, i + S)) for i in range(0, world, S)])
    s, d = rank % S, rank // S % data
    x = torch.load(run["inputs"])
    B, L = x["q"].shape[0], x["q"].shape[2]
    n, lq = B // data, L // S
    seq = SeqGroup(group, s, S).split(L)

    def part(t, dim=2):
        return t[d * n:(d + 1) * n].narrow(dim, s * lq, lq).contiguous()

    q, k, v = (part(x[name]).requires_grad_() for name in "qkv")
    bias = x["bias"]
    bias = (bias if bias.shape[0] == 1 else bias[d * n:(d + 1) * n])
    bias = bias.narrow(2, s * lq, lq).contiguous().requires_grad_()
    before = ring_attention.exchanges
    out = ring_attention.ring_self_attention(q, k, v, bias, seq,
                                             x["rate"], x["seed"])
    out.backward(part(x["ct"]))
    torch.save(dict(out=out.detach(), dq=q.grad, dk=k.grad, dv=v.grad,
                    dbias=bias.grad, rows=(d * n, s * lq),
                    exchanges=ring_attention.exchanges - before),
               run["out"].format(rank=rank))


class StackNet(torch.nn.Module):
    """A decoder stack's forward from its inputs: the causal head bias
    from its table, then the blocks."""

    def __init__(self, stack):
        super().__init__()
        self.stack = stack

    def forward(self, x, enc_out, kmask, cross_kmask, deterministic, gen):
        return self.stack(x, head_bias=self.stack.position_bias(
            x.shape[1], causal=True), kmask=kmask, enc_out=enc_out,
            cross_kmask=cross_kmask, deterministic=deterministic,
            generator=gen)


def run_stack(run: dict) -> None:
    """A pipelined decoder stack's forward and backward under FSDP2 (see
    the module doc)."""
    from torch.distributed.fsdp import fully_shard

    from klab_multimodalmodel_tpu_torch.models.t5 import T5Block, T5Stack
    from klab_multimodalmodel_tpu_torch.parallel.partitioning import (
        PipeGroup, gather_full)

    x = torch.load(run["inputs"])
    mesh = make_mesh(run["layout"])
    stack = T5Stack(tcfg.T5Size(**x["size"]), x["layers"], True,
                    pipeline_stages=mesh.pipe,
                    pipeline_microbatches=x["microbatches"])
    stack.load_state_dict(x["state"])
    stack.set_pipe_group(PipeGroup(mesh.pipe_group("cpu"), mesh.pipe_rank,
                                   mesh.pipe))
    stack.set_batch_share(mesh.dp_rank, mesh.dp_size)
    units = {"relative_attention_bias": stack.relative_attention_bias}
    units.update((f"block.{i}", b) for i, b in enumerate(stack.block)
                 if isinstance(b, T5Block))
    dp_mesh = mesh.device_mesh("cpu")["data", "fsdp"]
    for unit in units.values():
        fully_shard(unit, mesh=dp_mesh)
    # The root reads the table before the blocks run, as the model does.
    root = StackNet(stack)
    fully_shard(root, mesh=dp_mesh)
    n = x["x"].shape[0] // mesh.dp_size
    lo = mesh.dp_rank * n

    def mine(t):
        return t[lo:lo + n].clone()
    inp = mine(x["x"]).requires_grad_()
    enc = mine(x["enc_out"]).requires_grad_()
    gen = torch.Generator().manual_seed(x["seed"])
    y = root(inp, enc, mine(x["kmask"]), mine(x["cross_kmask"]),
             x["rate"] == 0, gen)
    (y * mine(x["ct"])).sum().backward()
    grads, local = {}, {}
    for name, p in stack.named_parameters():  # its own names
        grads[name] = None if p.grad is None else gather_full(p.grad)
        local[name] = None if p.grad is None else p.grad.to_local().clone()
    sharded = {k: all(isinstance(p, DTensor) and p.to_local().numel()
                      < p.numel() for p in unit.parameters())
               for k, unit in units.items()}
    torch.save(dict(grads=grads, local=local, sharded=sharded,
                    x_grad=inp.grad, enc_grad=enc.grad, rows=(lo, n)),
               run["out"].format(rank=mesh.rank))


def run_loop(run: dict) -> None:
    cfg = tcfg.Config(**run["config"])
    mesh = make_mesh(cfg.mesh_shape, cfg.mesh_axis_names,
                     cfg.dcn_mesh_shape)
    out = train(cfg, *loaders(cfg, run, mesh.dp_rank, mesh.dp_size),
                device="cpu")
    if mesh.rank == 0:
        with open(run["out"], "w") as f:
            json.dump(dict(losses=out["losses"], steps=out["steps"],
                           min_val_loss=out["min_val_loss"],
                           saves=[s["name"] for s in out["saves"]]), f)
    if run.get("params"):
        trainer = out["trainer"]
        # Sharded: the whole parameters on rank 0 (FSDP2's are DTensors).
        held = ({n: p for n, p in trainer.full_state_dict().items()
                 if n in dict(trainer.model.named_parameters())}
                if trainer.sharded else
                {n: p.detach() for n, p in trainer.model.named_parameters()})
        torch.save(held, run["params"].format(rank=mesh.rank))


def resume(run: dict, trainer) -> tuple:
    """Restore the checkpoint under ``run["resume"]`` into ``trainer``;
    each rank writes to ``reads`` (with ``{rank}``) the files it read and
    the files whose stored pieces overlap its own pieces. Returns the
    whole state and optimizer state then held (rank 0's)."""
    manager = CheckpointManager(run["resume"], trainer.mesh)
    name = manager.latest()
    manager.restore(name, trainer)
    reader = PieceReader(manager.path(name))
    want = set()
    for entry, rec in reader.entries.items():
        if "value" in rec:
            continue
        _, name, *key = entry.split("/")
        if name not in dict(trainer.model.named_parameters()):
            continue
        piece = (trainer.piece(name) if not key else trainer._state_piece(
            name, key[0], len(rec["shape"])))
        if piece is None or not all(n for _, n in piece):
            continue
        want.update(p["file"] for p in rec["pieces"]
                    if overlap(piece, record_piece(p)) is not None)
    with open(run["reads"].format(rank=trainer.mesh.rank), "w") as f:
        json.dump(dict(read=sorted(manager.files_read), want=sorted(want),
                       stored=sorted({p["file"] for r in
                                      reader.entries.values()
                                      for p in r.get("pieces", [])})), f)
    return trainer.full_state_dict(), trainer.full_optimizer_state_dict()


class AllocationWatch(TorchDispatchMode):
    """Every new storage an op makes (an output whose storage is none of
    its inputs'; meta tensors and DTensor wrappers aside, whose local
    tensors it sees) while ``making`` is set: the largest in elements; and
    while ``drawing`` is set, at each draw's whole temporary (an
    ``empty``), how many of the storages made since the last one are still
    alive (``stale``: the earlier parameters' temporaries, and a truncated
    normal's helpers)."""

    def __init__(self):
        super().__init__()
        self.largest = 0
        self.making = self.drawing = False
        self.live = weakref.WeakSet()
        self.stale = 0
        self.draws = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        def plain(t):  # not meta, not a wrapper subclass (DTensor)
            return type(t) is torch.Tensor and not t.is_meta

        inputs = {t.untyped_storage().data_ptr()
                  for t in torch.utils._pytree.tree_leaves((args, kwargs))
                  if plain(t)}
        for t in torch.utils._pytree.tree_leaves(out):
            if (self.making and plain(t) and t.numel()
                    and t.untyped_storage().data_ptr() not in inputs):
                self.largest = max(self.largest, t.numel())
                if not self.drawing:
                    continue
                if func is torch.ops.aten.empty.memory_format:
                    self.stale = max(self.stale, len(self.live))
                    self.draws += 1
                    self.live = weakref.WeakSet()
                self.live.add(t)
        return out


def run_init(run: dict) -> None:
    """``init_state`` alone on a seeded generator, under an
    ``AllocationWatch`` (``making`` from the pieces' ``to_empty`` to the
    end of ``_draw_pieces``, ``drawing`` inside it: not the DDP buckets or
    the optimizer after);
    each rank writes to ``out`` (with ``{rank}``) whether the parameters
    were on meta before, each held entry's piece and tensor, the buffers,
    the generator's state after, and the watch's readings."""
    cfg = tcfg.Config(**run["config"])
    trainer = Trainer(cfg, device="cpu")
    on_meta = all(p.is_meta for p in trainer.model.parameters())
    gen = torch.Generator().manual_seed(run["seed"])
    watch = AllocationWatch()
    draw, to_empty = trainer._draw_pieces, trainer.net.to_empty

    def making(**kw):
        watch.making = True
        return to_empty(**kw)

    def drawing(*a):
        watch.drawing = True
        try:
            draw(*a)
        finally:
            watch.making = watch.drawing = False
    trainer._draw_pieces, trainer.net.to_empty = drawing, making
    with watch:
        trainer.init_state(gen)
    torch.save(dict(
        on_meta=on_meta,
        pieces={n: (trainer.piece(n), t.detach().clone())
                for n, t in trainer._local_tensors().items()},
        buffers={n: b.clone() for n, b in trainer.model.named_buffers()},
        generator=gen.get_state(), largest=watch.largest, stale=watch.stale,
        draws=watch.draws), run["out"].format(rank=trainer.mesh.rank))


def run_interrupted(run: dict) -> None:
    """A save whose write dies on rank ``run["interrupt"]``: every rank
    writes to ``out`` (with ``{rank}``) what ``wait()`` raised and
    ``latest()``. Then a third save, after which every rank waits (up to
    a minute) to see it in place without calling ``wait()``, writes
    whether it did and exits at once, with no further call: the run must
    be its job's last."""
    from klab_multimodalmodel_tpu_torch.checkpoint import io

    cfg = tcfg.Config(**run["config"])
    trainer = Trainer(cfg, device="cpu")
    trainer.init_state()
    manager = CheckpointManager(run["result_dir"], trainer.mesh)
    manager.save("step_1", trainer)
    manager.wait()
    real = torch.save

    def dying(obj, path, *a, **kw):
        if path.endswith(f"{io.SHARDS}/{trainer.mesh.rank}.pt"):
            raise OSError("disk full")
        return real(obj, path, *a, **kw)
    if trainer.mesh.rank == run["interrupt"]:
        io.torch.save = dying
    trainer.step = 2
    manager.save("step_2", trainer)
    try:
        manager.wait()
        raised = None
    except RuntimeError as e:
        raised = str(e)
    io.torch.save = real
    latest = manager.latest()
    trainer.step = 3
    manager.save("step_3", trainer)
    deadline = time.monotonic() + 60
    while not manager.exists("step_3") and time.monotonic() < deadline:
        time.sleep(0.01)
    with open(run["out"].format(rank=trainer.mesh.rank), "w") as f:
        json.dump(dict(raised=raised, latest=latest,
                       committed=manager.exists("step_3")), f)
    os._exit(0)  # killed: no wait(), no barrier, no teardown


def run_one(run: dict) -> None:
    if run.get("init_check"):
        run_init(run)
        return
    if run.get("interrupt") is not None:
        run_interrupted(run)
        return
    if run.get("loop"):
        run_loop(run)
        return
    if run.get("ring"):
        run_ring(run)
        return
    if run.get("stack"):
        run_stack(run)
        return
    cfg = tcfg.Config(**run["config"])
    trainer = Trainer(cfg, device="cpu")
    mesh = trainer.mesh
    if run.get("pretrained"):
        trainer.init_state()
        load_pretrained_params(run["pretrained"], trainer)
    elif run.get("init"):
        trainer.init_state(state_dict=torch.load(run["init"]))
    else:
        trainer.init_state()
    resumed = resume(run, trainer) if run.get("resume") else (None, None)
    # Each data rank its own dropout stream, as train() draws them; with
    # ``one_stream`` all of them data rank 0's.
    gen = torch.Generator().manual_seed(dropout_seed(
        cfg.seed, 0 if run.get("one_stream") else mesh.dp_rank))
    before = ring_attention.exchanges
    shifts = partitioning.shifts
    losses = [float(trainer.train_step(rows(b, mesh), gen))
              for b in torch.load(run["batches"])]
    shifts = partitioning.shifts - shifts
    full = trainer.full_state_dict()
    full_opt = trainer.full_optimizer_state_dict()
    manager = CheckpointManager(run["result_dir"], mesh)
    manager.save(f"step_{trainer.step}", trainer)
    manager.wait()
    if run.get("local"):
        torch.save({n: (p.to_local() if isinstance(p, DTensor)
                        else p.detach()).clone()
                    for n, p in trainer.model.named_parameters()
                    if not (mesh.tensor > 1 and tensor_parallel(n))
                    or n.endswith(BANKS)},
                   run["local"].format(rank=mesh.rank))
    if run.get("held"):
        with open(run["held"].format(rank=mesh.rank), "w") as f:
            json.dump(dict(
                params=sum(4 * (p.to_local() if isinstance(p, DTensor)
                                else p).numel()
                           for p in trainer.model.parameters()),
                rank=mesh.rank,
                coordinate=trainer.mesh.device_mesh("cpu").get_coordinate()
                if trainer.partitioned else None), f)
    evals = [float(trainer.eval_step(rows(b, mesh)))
             for b in (torch.load(run["eval"]) if run.get("eval") else [])]
    restored = restored_opt = None
    if run.get("restore"):
        other = CheckpointManager(run["restore"], mesh)
        other.restore(other.latest(), trainer)
        restored = trainer.full_state_dict()
        restored_opt = trainer.full_optimizer_state_dict()
    if mesh.rank == 0:
        torch.save({"params": full, "optimizer": full_opt,
                    "resumed": resumed[0], "resumed_optimizer": resumed[1],
                    "restored": restored,
                    "restored_optimizer": restored_opt}, run["params"])
        with open(run["out"], "w") as f:
            json.dump(dict(losses=losses, step=trainer.step, evals=evals,
                           dp=[mesh.dp_rank, mesh.dp_size],
                           ring_exchanges=ring_attention.exchanges - before,
                           shifts=shifts,
                           ddp_ranks=(trainer.ddp.process_group.size()
                                      if trainer.ddp is not None else 0)),
                      f)


def main() -> None:
    spec = read_spec()
    torch.set_num_threads(1)
    maybe_init_distributed("cpu")
    for run in spec["runs"]:
        run_one(run)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
