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

A pretrained checkpoint (``save_pretrained``) is a directory with a
``model.pt`` holding some of the model's top-level submodules
(``image_model``, ``language_model``, ``transformer``, the projections).
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


def _load_optimizer_state(opt: torch.optim.Optimizer, state: dict) -> None:
    """``load_state_dict``, then the saved dtype of every state tensor:
    torch casts floating state to its parameter's dtype, which would turn
    ``AdamBf16Mu``'s bf16 first moment into fp32."""
    opt.load_state_dict(state)
    params = [p for g in opt.param_groups for p in g["params"]]
    for i, saved in state["state"].items():
        live = opt.state[params[int(i)]]
        for key, value in saved.items():
            if (isinstance(value, torch.Tensor)
                    and live[key].dtype != value.dtype):
                live[key] = live[key].to(value.dtype)


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
    fresh weights. Raises on submodules the model lacks. Returns the names
    loaded."""
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
        children[top].load_state_dict(sd, strict=True)
    return sorted(groups)


class CheckpointManager:
    """Saves and restores a ``Trainer``'s state under
    ``{result_dir}/checkpoints``. A save copies the state to the host and
    writes it to disk in a background thread; at most one save is in
    flight, and ``wait()`` drains it. ``saves`` records each save's name,
    bytes, the loop's stall (the copy to the host) and the write's
    seconds."""

    def __init__(self, result_dir: str):
        self.base = os.path.abspath(os.path.join(result_dir, "checkpoints"))
        os.makedirs(self.base, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None
        self.saves: list[dict] = []

    def path(self, name: str) -> str:
        return os.path.join(self.base, name)

    # -- save --------------------------------------------------------------
    def save(self, name: str, trainer, metadata: Optional[dict] = None
             ) -> str:
        self.wait()
        t0 = time.perf_counter()
        pinned = trainer.device.type == "cuda"
        model = _to_host(trainer.model.state_dict(), pinned)
        train_state = {
            "optimizer": _to_host(trainer.optimizer.state_dict(), pinned),
            "scheduler": trainer.scheduler.state_dict(),
            "step": int(trainer.step)}
        if pinned:
            torch.cuda.synchronize(trainer.device)
        record = {"name": name, "stall_s": time.perf_counter() - t0,
                  "bytes": _nbytes(model) + _nbytes(train_state)}
        self.saves.append(record)
        meta = {"steps": int(trainer.step), **(metadata or {})}
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
        """Block until the save in flight is on disk; raise its error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("checkpoint write failed") from err

    # -- restore -----------------------------------------------------------
    def exists(self, name: str) -> bool:
        return os.path.isdir(self.path(name))

    def restore(self, name: str, trainer) -> None:
        """Load checkpoint ``name`` into ``trainer`` (its model with
        ``strict=True``, optimizer, schedule and step count)."""
        self.wait()
        d = self.path(name)
        trainer.model.load_state_dict(
            torch.load(os.path.join(d, MODEL_FILE), map_location="cpu",
                       weights_only=True), strict=True)
        state = torch.load(os.path.join(d, TRAIN_STATE_FILE),
                           map_location="cpu", weights_only=True)
        _load_optimizer_state(trainer.optimizer, state["optimizer"])
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
