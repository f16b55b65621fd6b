"""Checkpoint save and restore, and pretrained initialization.

Checkpoints are named ``best`` / ``epoch_N`` / ``step_N`` under
``{result_dir}/checkpoints``, as the reference names them. Each holds the
full training state (the model's parameters, the optimizer's and the
schedule's state and the optimizer-step count), so a run resumes exactly; a
``{name}.meta.json`` sidecar beside it holds the loop's metadata (epoch,
steps, ``min_val_loss``, the step generator's state, the loss partials).

A checkpoint is a directory: ``model.pt`` (the model's state dict),
``train_state.pt`` (optimizer, schedule, step) and ``meta.json`` (the
metadata again, with the step count). It is written under a temporary name
and renamed into place, so ``latest()`` never sees a partial one; its
``meta.json`` travels in the same rename, so a checkpoint whose sidecar is
missing still ranks by its own step count.

Across processes (a ``utils.mesh.Mesh`` with a process group) rank 0 alone
writes, and ``wait()`` ends at a barrier, so that every rank passes it only
once rank 0's write is renamed into place; every rank restores, each from
the same files. Under DDP, and over data x seq, every rank holds the whole
state already. Under
FSDP2 and tensor parallelism every rank takes part in gathering it whole
to rank 0's host (``Trainer.full_state_dict`` /
``full_optimizer_state_dict``), so rank 0 writes the files one process
writes; a restore cuts every rank's shards out of them again
(``load_full_state_dict`` / ``load_full_optimizer_state_dict``). A
checkpoint does not record the world size or mesh that wrote it and
resumes at any other, one process included.

A pretrained checkpoint (``save_pretrained``) is a directory with a
``model.pt`` holding some of the model's top-level submodules
(``image_model``, ``language_model``, ``transformer``, the projections).
A dense ``transformer`` loaded into an MoE model is sparse-upcycled
(``models.t5.upcycle_t5_params``: every expert a copy of its block's dense
MLP, the router fresh), as the JAX package's ``load_pretrained_params``
does; a full-state resume across the dense/MoE boundary raises, since the
experts' optimizer moments have no dense counterpart (an MoE checkpoint's
metadata holds ``"moe": true``).

Pipeline stage counts need no conversion: the port's layers keep their
names whatever ``pipeline_stages`` is, so a checkpoint written at one stage
count loads at any other (the JAX package reshapes its pipelined layout).
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
from typing import Any, Optional

import torch

from ..models.t5 import upcycle_t5_params
from ..utils.mesh import barrier

MODEL_FILE = "model.pt"
TRAIN_STATE_FILE = "train_state.pt"
META_FILE = "meta.json"


def _to_host(obj: Any, pinned: bool) -> Any:
    """A copy of ``obj`` with every tensor on the host: CUDA tensors into
    pinned buffers, asynchronously (the caller synchronizes once); CPU
    tensors cloned, since training goes on updating them in place."""
    if isinstance(obj, torch.Tensor):
        t = obj.detach()
        if t.device.type == "cpu":
            return t.clone()
        out = torch.empty(t.shape, dtype=t.dtype, pin_memory=pinned)
        return out.copy_(t, non_blocking=pinned)
    if isinstance(obj, dict):
        return {k: _to_host(v, pinned) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v, pinned) for v in obj)
    return obj


def _nbytes(obj: Any) -> int:
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if isinstance(obj, dict):
        return sum(_nbytes(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return sum(_nbytes(v) for v in obj)
    return 0


def _write_json(path: str, obj: dict) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)


def save_pretrained(path: str, state_dict: dict) -> str:
    """Write ``state_dict`` (all or some of the model's top-level
    submodules, e.g. ``convert_jax_params``'s output) as a pretrained
    checkpoint under ``{path}/checkpoints/pretrained``."""
    out = os.path.join(path, "checkpoints", "pretrained")
    os.makedirs(out, exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in state_dict.items()},
               os.path.join(out, MODEL_FILE))
    return out


def load_pretrained_params(path: str, trainer) -> list[str]:
    """Initialize the top-level submodules present in the pretrained
    checkpoint at ``path`` (or ``path/checkpoints/pretrained``) into
    ``trainer.model``, each with ``strict=True``; the others keep their
    fresh weights. Raises on submodules the model lacks. ``trainer``: a
    ``Trainer`` (a sharded one takes them through its
    ``load_full_state_dict``) or any object with a ``model``. Returns the
    names loaded."""
    p = os.path.abspath(path)
    cand = os.path.join(p, "checkpoints", "pretrained")
    if os.path.isdir(cand):
        p = cand
    saved = torch.load(os.path.join(p, MODEL_FILE), map_location="cpu",
                       weights_only=True)
    groups: dict[str, dict] = {}
    for key, value in saved.items():
        top, _, rest = key.partition(".")
        groups.setdefault(top, {})[rest] = value
    model = trainer.model
    children = dict(model.named_children())
    missing = sorted(k for k in groups if k not in children)
    if missing:
        raise ValueError(
            f"pretrained checkpoint {p} contains submodules {missing} the "
            "model does not have: geometry/config mismatch")
    for top, sd in groups.items():
        fresh = children[top].state_dict()
        if top == "transformer" and is_moe(fresh) and not is_moe(sd):
            sd = upcycle_t5_params(sd, fresh)
        if not getattr(trainer, "partitioned", False):
            children[top].load_state_dict(sd, strict=True)
            continue
        if set(sd) != set(fresh):
            raise RuntimeError(
                f"pretrained {top}: missing {sorted(set(fresh) - set(sd))}, "
                f"unexpected {sorted(set(sd) - set(fresh))}")
        trainer.load_full_state_dict(
            {f"{top}.{k}": v for k, v in sd.items()}, strict=False)
    return sorted(groups)


def is_moe(state_dict) -> bool:
    """Whether a state dict holds MoE expert banks (``T5MoeMlp``)."""
    return any(k.endswith(".mlp.experts_wi") for k in state_dict)


class CheckpointManager:
    """Saves and restores a ``Trainer``'s state under
    ``{result_dir}/checkpoints``. A save copies the state to the host and
    writes it to disk in a background thread; at most one save is in
    flight, and ``wait()`` drains it. ``saves`` records each save's name,
    bytes, the loop's stall (the copy to the host) and the write's
    seconds. ``mesh``: across processes, only its rank 0 writes."""

    def __init__(self, result_dir: str, mesh=None):
        self.base = os.path.abspath(os.path.join(result_dir, "checkpoints"))
        os.makedirs(self.base, exist_ok=True)
        self._mesh = mesh if mesh is not None and mesh.distributed else None
        self.writer = self._mesh is None or self._mesh.rank == 0
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None
        self.saves: list[dict] = []

    def path(self, name: str) -> str:
        return os.path.join(self.base, name)

    # -- save --------------------------------------------------------------
    def save(self, name: str, trainer, metadata: Optional[dict] = None
             ) -> str:
        self.wait()
        sharded = trainer.partitioned
        if not (self.writer or sharded):
            return self.path(name)
        t0 = time.perf_counter()
        pinned = trainer.device.type == "cuda"
        if sharded:
            # Every rank gathers; rank 0 holds the whole state, on the host.
            model = trainer.full_state_dict()
            optimizer = trainer.full_optimizer_state_dict()
            if not self.writer:
                return self.path(name)
        else:
            model = _to_host(trainer.model.state_dict(), pinned)
            optimizer = _to_host(trainer.optimizer.state_dict(), pinned)
        train_state = {
            "optimizer": optimizer,
            "scheduler": trainer.scheduler.state_dict(),
            "step": int(trainer.step)}
        if pinned:
            torch.cuda.synchronize(trainer.device)
        record = {"name": name, "stall_s": time.perf_counter() - t0,
                  "bytes": _nbytes(model) + _nbytes(train_state)}
        self.saves.append(record)
        meta = {"steps": int(trainer.step), **(metadata or {})}
        if is_moe(model):
            meta["moe"] = True
        self._thread = threading.Thread(
            target=self._write, args=(name, model, train_state, meta, record),
            daemon=False)
        self._thread.start()
        return self.path(name)

    def _write(self, name, model, train_state, meta, record) -> None:
        try:
            t0 = time.perf_counter()
            tmp = os.path.join(self.base, f".{name}.tmp")
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            torch.save(model, os.path.join(tmp, MODEL_FILE))
            torch.save(train_state, os.path.join(tmp, TRAIN_STATE_FILE))
            _write_json(os.path.join(tmp, META_FILE), meta)
            final, sidecar = self.path(name), self._sidecar(name)
            old = None
            if os.path.exists(final):
                # Never a sidecar beside contents it does not describe: it
                # goes first, and the old directory's own meta.json
                # describes it until the rename.
                if os.path.exists(sidecar):
                    os.remove(sidecar)
                old = os.path.join(self.base, f".{name}.old")
                shutil.rmtree(old, ignore_errors=True)
                os.rename(final, old)
            os.rename(tmp, final)
            _write_json(sidecar, meta)
            if old is not None:
                shutil.rmtree(old, ignore_errors=True)
            record["write_s"] = time.perf_counter() - t0
        except Exception as e:  # the thread's boundary: wait() raises it
            self._error = e

    def wait(self) -> None:
        """Block until the save in flight is on disk (across processes:
        every rank, until rank 0's is); raise its error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("checkpoint write failed") from err
        if self._mesh is not None:
            barrier(self._mesh)

    # -- restore -----------------------------------------------------------
    def exists(self, name: str) -> bool:
        return os.path.isdir(self.path(name))

    def restore(self, name: str, trainer) -> None:
        """Load checkpoint ``name`` into ``trainer`` (its model with
        ``strict=True``, optimizer, schedule and step count). Raises
        ``ValueError`` across the dense/MoE boundary."""
        self.wait()
        d = self.path(name)
        saved = torch.load(os.path.join(d, MODEL_FILE), map_location="cpu",
                           weights_only=True)
        saved_moe = (self.load_metadata(name) or {}).get("moe",
                                                          is_moe(saved))
        target_moe = trainer.config.moe_experts > 0
        if saved_moe != target_moe:
            raise ValueError(
                f"checkpoint {name} is {'MoE' if saved_moe else 'dense'} "
                f"but the target model is {'MoE' if target_moe else 'dense'}"
                ": full-state resume cannot cross the dense/MoE boundary "
                "(expert optimizer moments have no dense counterpart). For "
                "dense -> MoE, sparse-upcycle the params with "
                "--init_checkpoint (fresh optimizer), per Komatsuzaki et "
                "al. 2023.")
        trainer.load_full_state_dict(saved, strict=True)
        state = torch.load(os.path.join(d, TRAIN_STATE_FILE),
                           map_location="cpu", weights_only=True)
        trainer.load_full_optimizer_state_dict(state["optimizer"])
        trainer.scheduler.load_state_dict(state["scheduler"])
        trainer.step = int(state["step"])

    def _sidecar(self, name: str) -> str:
        return os.path.join(self.base, f"{name}.meta.json")

    def load_metadata(self, name: str) -> Optional[dict]:
        """The sidecar, or the checkpoint's own ``meta.json`` where the
        sidecar is missing; None if neither exists."""
        for p in (self._sidecar(name),
                  os.path.join(self.path(name), META_FILE)):
            if os.path.exists(p):
                with open(p) as f:
                    return json.load(f)
        return None

    # -- resume discovery --------------------------------------------------
    def latest(self) -> Optional[str]:
        """The most advanced interval checkpoint (``epoch_N`` / ``step_N``)
        by the optimizer-step count it records (the sidecar's, else its own
        ``meta.json``'s); the name's N breaks ties. A directory with neither
        is no checkpoint of this manager's and is skipped."""
        best_key, best_name = None, None
        for entry in os.listdir(self.base):
            m = re.fullmatch(r"(epoch|step)_(\d+)", entry)
            if not (m and os.path.isdir(self.path(entry))):
                continue
            steps = (self.load_metadata(entry) or {}).get("steps")
            if steps is None:
                continue
            key = (int(steps), int(m.group(2)))
            if best_key is None or key > best_key:
                best_key, best_name = key, entry
        return best_name
