"""One rank of a sharded training job of the port on the CPU (gloo), for
the tests of FSDP2 and tensor parallelism:

    python -m torch.distributed.run --nproc_per_node W \\
        tests/_torch_shard_worker.py SPEC.json

SPEC.json holds the tiny geometries to register (as
``_torch_ddp_worker.py`` reads them) and ``runs``, one after another in
the one process group. A run is a dict of ``config`` (``Config`` fields,
its ``mesh_shape`` the layout), ``init`` (a ``.pt`` state dict every rank
loads) or ``pretrained`` (a ``save_pretrained`` directory that every rank
loads through ``load_pretrained_params`` over its seeded weights),
``batches`` (a ``.pt`` list of global batches; each data rank
takes its rows), ``result_dir`` (its checkpoint ``step_N`` is written
there), ``out`` (rank 0's JSON: the losses), ``params`` (rank 0's ``.pt``:
the whole parameters gathered after the steps) and optionally ``local``
(a ``.pt`` path with ``{rank}``: each rank's own shards of the parameters
that no tensor rank splits) and ``restore`` (a checkpoint directory's
``result_dir`` whose ``step_N`` this run restores after its steps; rank 0
writes the whole parameters then held to ``restored``). A run with
``loop`` instead runs ``train()`` on the skewed synthetic rows of
``_torch_ddp_worker.loaders`` (``n_train``, ``n_val``, ``global_batch``),
each data rank on its chunk, and rank 0 writes its losses to ``out``.
Needs no JAX.
"""

import json

import torch
import torch.distributed as dist

from _torch_ddp_worker import loaders, read_spec
from klab_multimodalmodel_tpu_torch import config as tcfg
from klab_multimodalmodel_tpu_torch.checkpoint.io import (
    CheckpointManager, load_pretrained_params)
from klab_multimodalmodel_tpu_torch.parallel.partitioning import (
    tensor_parallel)
from klab_multimodalmodel_tpu_torch.train import Trainer, train
from klab_multimodalmodel_tpu_torch.train.loop import dropout_seed
from klab_multimodalmodel_tpu_torch.utils.mesh import (make_mesh,
                                                      maybe_init_distributed)


def rows(batch: dict, mesh) -> dict:
    """This data rank's chunk of a global batch."""
    n = next(iter(batch.values())).shape[0] // mesh.dp_size
    lo = mesh.dp_rank * n
    return {k: v[lo:lo + n] for k, v in batch.items()}


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


def run_one(run: dict) -> None:
    if run.get("loop"):
        run_loop(run)
        return
    cfg = tcfg.Config(**run["config"])
    trainer = Trainer(cfg, device="cpu")
    mesh = trainer.mesh
    if run.get("pretrained"):
        trainer.init_state()
        load_pretrained_params(run["pretrained"], trainer)
    else:
        trainer.init_state(state_dict=torch.load(run["init"]))
    gen = torch.Generator().manual_seed(dropout_seed(cfg.seed, mesh.dp_rank))
    losses = [float(trainer.train_step(rows(b, mesh), gen))
              for b in torch.load(run["batches"])]
    full = trainer.full_state_dict()
    manager = CheckpointManager(run["result_dir"], mesh)
    manager.save(f"step_{trainer.step}", trainer)
    manager.wait()
    if run.get("local"):
        torch.save({n: p.to_local().clone()
                    for n, p in trainer.model.named_parameters()
                    if not tensor_parallel(n)},
                   run["local"].format(rank=mesh.rank))
    restored = None
    if run.get("restore"):
        other = CheckpointManager(run["restore"], mesh)
        other.restore(other.latest(), trainer)
        restored = trainer.full_state_dict()
    if mesh.rank == 0:
        torch.save({"params": full, "restored": restored}, run["params"])
        with open(run["out"], "w") as f:
            json.dump(dict(losses=losses, step=trainer.step,
                           dp=[mesh.dp_rank, mesh.dp_size]), f)


def main() -> None:
    spec = read_spec()
    torch.set_num_threads(1)
    maybe_init_distributed("cpu")
    for run in spec["runs"]:
        run_one(run)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
