"""One rank of a training job of the port on the CPU, for the DDP tests:

    python -m torch.distributed.run --nproc_per_node 2 \\
        tests/_torch_ddp_worker.py SPEC.json

SPEC.json holds the tiny geometries to register (``t5_sizes``,
``swin_sizes``: name -> the size's fields) and ``runs``, each run a dict
of ``config`` (``Config`` fields), ``n_train`` / ``n_val`` (rows of the
skewed synthetic dataset), ``global_batch``, ``out`` (this rank's JSON,
with ``{rank}``), and optionally ``sigterm_after`` ({rank: update}: the
rank sends itself SIGTERM after that update) and ``params`` (a ``.pt``
path, with ``{rank}``, for the trainable parameters at the end). The runs
go one after another in the one process group. Needs no JAX.
"""

import json
import os
import signal
import sys

import torch
import torch.distributed as dist

from klab_multimodalmodel_tpu_torch import config as tcfg
from klab_multimodalmodel_tpu_torch.data import (DataLoader,
                                                 SyntheticCaptionDataset)
from klab_multimodalmodel_tpu_torch.text import ByteTokenizer
from klab_multimodalmodel_tpu_torch.train import Trainer, train
from klab_multimodalmodel_tpu_torch.utils.mesh import maybe_init_distributed


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Job:
    """This worker (or another ``script`` that reads the same spec) under
    torchrun (``--standalone``: a free local port), started in the
    background with ``runs``; ``results()`` waits for it
    and returns, per run, the ranks' results. ``sizes``: the geometries to
    register, {"t5_sizes": ..., "swin_sizes": ...}."""

    def __init__(self, tmp_path, runs: list, sizes: dict, nproc: int = 2,
                 timeout: float = 240, script: str = __file__):
        import subprocess

        self.runs, self.nproc, self.timeout = runs, nproc, timeout
        spec_path = os.path.join(str(tmp_path), "spec.json")
        with open(spec_path, "w") as f:
            json.dump(dict(sizes, runs=runs), f)
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("KLAB_", "MASTER_", "TORCHELASTIC"))
               and k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
        env["OMP_NUM_THREADS"] = "1"
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc_per_node", str(nproc), os.path.abspath(script),
             spec_path], env=env, cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)

    def wait(self) -> str:
        """Wait for the job (it must succeed); its output."""
        try:
            log, _ = self.proc.communicate(timeout=self.timeout)
        finally:
            self.proc.kill()
        assert self.proc.returncode == 0, log[-8000:]
        return log

    def results(self) -> list:
        self.wait()
        out = []
        for run in self.runs:
            ranks = []
            for r in range(self.nproc):
                with open(run["out"].format(rank=r)) as f:
                    ranks.append(json.load(f))
            out.append(ranks)
        return out


def loaders(cfg, run, rank, world):
    def make(n, shuffle):
        return DataLoader(
            SyntheticCaptionDataset(n=n, image_size=cfg.swin.image_size,
                                    skew=True),
            ByteTokenizer(), global_batch_size=run["global_batch"],
            max_source_length=cfg.max_source_length,
            max_target_length=cfg.max_target_length, shuffle=shuffle,
            seed=cfg.seed, num_workers=1, process_index=rank,
            process_count=world)
    return make(run["n_train"], True), make(run["n_val"], False)


class StepLog:
    """Records each train step's loss, kind and target width on this rank,
    and sends SIGTERM to this process after a chosen update."""

    def __init__(self, sigterm_after=None):
        self.steps = []
        self.sigterm_after = sigterm_after
        self._saved = {}

    def __enter__(self):
        for name in ("train_step", "train_step_with_features"):
            orig = getattr(Trainer, name)
            self._saved[name] = orig
            setattr(Trainer, name, self._wrap(orig))
        return self

    def __exit__(self, *exc):
        for name, orig in self._saved.items():
            setattr(Trainer, name, orig)

    def _wrap(self, orig):
        log = self

        def step(trainer, batch, *args):
            out = orig(trainer, batch, *args)
            loss = out[0] if isinstance(out, tuple) else out
            log.steps.append(dict(
                loss=float(loss),
                cached="image_features" in batch,
                target_width=int(batch["target_ids"].shape[1]),
                source_width=int(batch["source_ids"].shape[1])))
            if log.sigterm_after == len(log.steps):
                os.kill(os.getpid(), signal.SIGTERM)
            return out
        return step


def read_spec() -> dict:
    """The spec file named on the command line, its sizes registered."""
    with open(sys.argv[1]) as f:
        spec = json.load(f)
    for name, kw in spec["t5_sizes"].items():
        tcfg.register_t5_size(name, tcfg.T5Size(**kw))
    for name, kw in spec["swin_sizes"].items():
        tcfg.register_swin_size(name, tcfg.SwinV2Size(**{
            k: tuple(v) if isinstance(v, list) else v
            for k, v in kw.items()}))
    return spec


def main() -> None:
    spec = read_spec()
    torch.set_num_threads(1)
    maybe_init_distributed("cpu")
    rank, world = dist.get_rank(), dist.get_world_size()
    for run in spec["runs"]:
        cfg = tcfg.Config(**run["config"])
        sigterm = (run.get("sigterm_after") or {}).get(str(rank))
        with StepLog(sigterm) as log:
            out = train(cfg, *loaders(cfg, run, rank, world), device="cpu")
        model = out["trainer"].model
        result = dict(rank=rank, world=world, losses=out["losses"],
                      min_val_loss=out["min_val_loss"], steps=out["steps"],
                      halted=out["halted"], step_log=log.steps,
                      saves=[s["name"] for s in out["saves"]],
                      generator_seed=out["generator"].initial_seed())
        if run.get("params"):
            torch.save({n: p.detach() for n, p in model.named_parameters()},
                       run["params"].format(rank=rank))
        with open(run["out"].format(rank=rank), "w") as f:
            json.dump(result, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
