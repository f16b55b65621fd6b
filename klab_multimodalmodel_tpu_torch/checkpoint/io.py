"""Checkpoint save and restore, and pretrained initialization.

Checkpoints are named ``best`` / ``epoch_N`` / ``step_N`` under
``{result_dir}/checkpoints``, as the reference names them. Each holds the
full training state (the model's parameters, the optimizer's and the
schedule's state and the optimizer-step count), so a run resumes exactly; a
``{name}.meta.json`` sidecar beside it holds the loop's metadata (epoch,
steps, ``min_val_loss``, the step generator's state, the loss partials).

A checkpoint is a directory of pieces, one format for every layout:

* ``shards/{rank}.pt``: the pieces that rank ``rank`` wrote, each under a
  key of its own: the blocks of the whole model's and optimizer's tensors
  that it is the lowest rank to hold (``Trainer.owned_pieces``), so that
  each piece is written once (a data or seq replica, a frozen tower kept
  whole over ``tensor``, ``Adafactor``'s state kept whole over the shards
  is written by one rank); a rank that owns none writes no file;
* ``index.json``: for every entry ("model/{name}", and the optimizer's
  state as "optimizer/{name}/{key}"), its whole shape and dtype and the
  file, key, offsets and lengths of each stored piece, or its plain value
  (a step count);
* ``train_state.pt``: the schedule's state, the optimizer-step count, the
  whole model's param groups by name, the groups' hyperparameters and
  whether the optimizer keeps its state whole over the shards;
* ``meta.json``: the metadata again, with the step count (and ``"moe":
  true`` for an MoE model).

A save copies each rank's pieces to the host (pinned buffers on the card)
and writes them in a background thread into ``.{name}.tmp``, each rank its
own ``shards/{rank}.pt`` and then, last, a listing of its records beside it
(``{rank}.json``: the mark that it is done; a rank whose write fails marks
``{rank}.failed`` instead). Rank 0's thread then waits for every rank's
mark, merges the listings into ``index.json`` and renames the directory
into place, or gives up if any rank failed. So a save is committed as soon
as its last rank has written, whatever the loop does next; ``latest()``
never sees a partial checkpoint, and a save that failed on any rank leaves
none. ``wait()`` joins the thread and agrees over the host's gloo group
whether every rank's part (and rank 0's commit) succeeded.

A restore reads ``index.json`` on every rank; each rank reads only the
stored pieces that overlap its own pieces (``torch.load(..., mmap=True)``)
and copies the overlaps. So a checkpoint written on any layout restores on
any other: one process, DDP, FSDP2 x tensor, pipe stages, expert banks.
Every state tensor keeps its saved dtype. ``read_whole`` /
``read_whole_optimizer`` assemble the whole model's (and optimizer's) state
on the host, for the CLI, the HF export and tests.

A pretrained checkpoint (``save_pretrained``) is a directory with a
``model.pt`` holding some of the model's top-level submodules
(``image_model``, ``language_model``, ``transformer``, the projections).
It is read memory-mapped, and a partitioned rank copies only its pieces.
A dense ``transformer`` loaded into an MoE model is sparse-upcycled
(``models.t5.upcycle_t5_params``: every expert a copy of its block's dense
MLP, the router fresh), as the JAX package's ``load_pretrained_params``
does; a full-state resume across the dense/MoE boundary raises, since the
experts' optimizer moments have no dense counterpart.

Pipeline stage counts need no conversion: the port's layers keep their
names whatever ``pipeline_stages`` is, so a checkpoint written at one stage
count loads at any other (the JAX package reshapes its pipelined layout).
"""

from __future__ import annotations

import json
import math
import os
import re
import shutil
import threading
import time
from typing import Any, Optional

import torch

from ..models.t5 import upcycle_t5_params
from ..parallel.partitioning import (assemble, overlap, piece_view,
                                     record_piece)
from ..utils.mesh import TIMEOUT, barrier, host_all_reduce

MODEL_FILE = "model.pt"
TRAIN_STATE_FILE = "train_state.pt"
META_FILE = "meta.json"
INDEX_FILE = "index.json"
SHARDS = "shards"


def _to_host(t: torch.Tensor, pinned: bool) -> torch.Tensor:
    """A copy of ``t`` on the host: a CUDA tensor into a pinned buffer,
    asynchronously (the caller synchronizes once); a CPU tensor cloned,
    since training goes on updating it in place."""
    t = t.detach()
    if t.device.type == "cpu":
        return t.clone()
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=pinned)
    return out.copy_(t, non_blocking=pinned)


def _write_json(path: str, obj) -> None:
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
    ``Trainer`` (a partitioned one copies its pieces out of the file,
    which is read memory-mapped, through ``load_full_state_dict``) or any
    object with a ``model``. Returns the names loaded."""
    p = os.path.abspath(path)
    cand = os.path.join(p, "checkpoints", "pretrained")
    if os.path.isdir(cand):
        p = cand
    saved = torch.load(os.path.join(p, MODEL_FILE), map_location="cpu",
                       mmap=True, weights_only=True)
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
    partitioned = getattr(trainer, "partitioned", False)
    for top, sd in groups.items():
        if partitioned:
            # The whole shapes, on meta: the rank holds pieces.
            fresh = {n[len(top) + 1:]: torch.empty(s, device="meta")
                     for n, s in trainer.whole_shapes().items()
                     if n.startswith(f"{top}.")}
        else:
            fresh = children[top].state_dict()
        if top == "transformer" and is_moe(fresh) and not is_moe(sd):
            sd = upcycle_t5_params(sd, fresh)
        if not partitioned:
            children[top].load_state_dict(sd, strict=True)
            continue
        if set(sd) != set(fresh):
            raise RuntimeError(
                f"pretrained {top}: missing {sorted(set(fresh) - set(sd))}, "
                f"unexpected {sorted(set(sd) - set(fresh))}")
        # An upcycled router is the fresh one, already in place.
        trainer.load_full_state_dict(
            {f"{top}.{k}": v for k, v in sd.items() if not v.is_meta},
            strict=False)
    return sorted(groups)


def is_moe(state_dict) -> bool:
    """Whether a state dict holds MoE expert banks (``T5MoeMlp``)."""
    return any(k.endswith(".mlp.experts_wi") for k in state_dict)


class PieceReader:
    """The stored pieces of a checkpoint directory, by its ``index.json``:
    ``read(entry, piece, out)`` fills a piece of an entry from the stored
    pieces that overlap it; each file is opened memory-mapped once, when a
    read first needs it (``opened``)."""

    def __init__(self, directory: str):
        self.directory = directory
        with open(os.path.join(directory, INDEX_FILE)) as f:
            self.index = json.load(f)
        self.entries = self.index["entries"]
        self._files: dict = {}
        self.opened: list[str] = []

    def _file(self, name: str) -> dict:
        if name not in self._files:
            self._files[name] = torch.load(
                os.path.join(self.directory, name), map_location="cpu",
                mmap=True, weights_only=True)
            self.opened.append(name)
        return self._files[name]

    def read(self, entry: str, piece: tuple, out: torch.Tensor
             ) -> torch.Tensor:
        """Fill ``out`` (the piece's shape, any device and dtype) with
        ``piece`` of ``entry``, copying each overlapping stored piece
        straight into its place; returns ``out``."""
        rec = self.entries[entry]
        if out.numel() == 0:
            return out
        filled = 0
        for stored in rec["pieces"]:
            src = record_piece(stored)
            both = overlap(piece, src)
            if both is None:
                continue
            part = piece_view(self._file(stored["file"])[stored["key"]],
                              both, src)
            if part.device != out.device and part.is_contiguous():
                # One plain copy to the device, then the placing there.
                part = part.to(out.device)
            piece_view(out, both, piece).copy_(part)
            filled += math.prod(n for _, n in both)
        if filled != out.numel():
            raise RuntimeError(f"{entry}: the stored pieces fill "
                               f"{filled} of {out.numel()} elements of "
                               f"{piece}")
        return out

    def whole(self, prefix: str) -> dict:
        """{entry: whole tensor or value} of every entry under ``prefix``
        ("model/" or "optimizer/")."""
        pieces = []
        for entry, rec in self.entries.items():
            if not entry.startswith(prefix):
                continue
            if "value" in rec:
                pieces.append((dict(entry=entry, value=rec["value"]), None))
                continue
            for stored in rec["pieces"]:
                pieces.append((dict(stored, entry=entry, shape=rec["shape"],
                                    dtype=rec["dtype"]),
                               self._file(stored["file"])[stored["key"]]))
        return assemble(pieces)


def read_whole(path: str) -> dict:
    """The whole model state dict of the checkpoint directory ``path``,
    assembled on the host from its pieces."""
    whole = PieceReader(path).whole("model/")
    return {entry[len("model/"):]: v for entry, v in whole.items()}


def read_whole_optimizer(path: str) -> dict:
    """The whole optimizer state dict (one process's form) of the
    checkpoint directory ``path``, assembled on the host."""
    # Not at the top: ``train`` imports this module.
    from ..train.optim import optimizer_state

    state = torch.load(os.path.join(path, TRAIN_STATE_FILE),
                       map_location="cpu", weights_only=True)
    return optimizer_state(PieceReader(path).whole("optimizer/"),
                           state["groups"], state["hyper"])


class CheckpointManager:
    """Saves and restores a ``Trainer``'s state under
    ``{result_dir}/checkpoints``. A save copies the rank's pieces to the
    host and writes them in a background thread, which on rank 0 also
    commits the save once every rank has written; at most one save is in
    flight, and ``wait()`` drains it. ``saves`` records each save that
    this rank wrote pieces of: its name, the rank's bytes, the loop's stall
    (the copy to the host) and the write's seconds (on rank 0, to the
    commit). ``mesh``: the trainer's, across processes (a save takes the
    trainer's)."""

    def __init__(self, result_dir: str, mesh=None):
        self.base = os.path.abspath(os.path.join(result_dir, "checkpoints"))
        os.makedirs(self.base, exist_ok=True)
        self._mesh = mesh if mesh is not None and mesh.distributed else None
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None
        self.saves: list[dict] = []
        # The files the last restore read (relative to its directory).
        self.files_read: list[str] = []

    @property
    def rank(self) -> int:
        return 0 if self._mesh is None else self._mesh.rank

    def path(self, name: str) -> str:
        return os.path.join(self.base, name)

    # -- save --------------------------------------------------------------
    def save(self, name: str, trainer, metadata: Optional[dict] = None
             ) -> str:
        """Start saving ``trainer``'s state as checkpoint ``name`` (every
        rank calls it)."""
        self.wait()
        mesh = trainer.mesh
        self._mesh = mesh if mesh.distributed else None
        t0 = time.perf_counter()
        pinned = trainer.device.type == "cuda"
        rank = self.rank
        records, tensors = [], {}
        for i, (rec, t) in enumerate(trainer.owned_pieces()):
            if t is not None:
                rec = dict(rec, file=f"{SHARDS}/{rank}.pt", key=str(i))
                tensors[str(i)] = _to_host(t, pinned)
            records.append(rec)
        train_state = None
        if rank == 0:
            opt = trainer.optimizer
            train_state = {
                "scheduler": trainer.scheduler.state_dict(),
                "step": int(trainer.step),
                "groups": trainer._whole_groups,
                "hyper": {k: v for k, v in opt.param_groups[0].items()
                          if k != "params"},
                "whole_state": bool(getattr(opt, "whole_state", False))}
            # An earlier attempt's marks must not count for this one.
            shutil.rmtree(self._tmp(name), ignore_errors=True)
        if self._mesh is not None:
            barrier(self._mesh)
        if pinned:
            torch.cuda.synchronize(trainer.device)
        record = {"name": name, "rank": rank,
                  "stall_s": time.perf_counter() - t0,
                  "bytes": sum(t.numel() * t.element_size()
                               for t in tensors.values())}
        if tensors or rank == 0:  # a rank that holds no piece writes none
            self.saves.append(record)
        meta = {"steps": int(trainer.step), **(metadata or {})}
        if trainer.config.moe_experts > 0:
            meta["moe"] = True
        self._thread = threading.Thread(
            target=self._write,
            args=(name, rank, mesh.layout().numel(), tensors, records,
                  train_state, record, meta),
            daemon=False)
        self._thread.start()
        return self.path(name)

    def _tmp(self, name: str) -> str:
        return os.path.join(self.base, f".{name}.tmp")

    def _write(self, name, rank, world, tensors, records, train_state,
               record, meta) -> None:
        """This rank's part of a save, into ``.{name}.tmp``: its pieces,
        on rank 0 the train state, then its listing of them (its mark), or
        on a failure its ``.failed`` mark; on rank 0 then the commit."""
        t0 = time.perf_counter()
        shards = os.path.join(self._tmp(name), SHARDS)
        try:
            os.makedirs(shards, exist_ok=True)
            if tensors:
                torch.save(tensors, os.path.join(shards, f"{rank}.pt"))
            if train_state is not None:
                torch.save(train_state, os.path.join(self._tmp(name),
                                                     TRAIN_STATE_FILE))
            _write_json(os.path.join(shards, f"{rank}.json"), records)
            if rank == 0:
                self._commit(name, world, meta)
            record["write_s"] = time.perf_counter() - t0
        except Exception as e:  # the thread's boundary: wait() raises it
            self._error = e
            if rank != 0:
                try:
                    open(os.path.join(shards, f"{rank}.failed"), "w").close()
                except OSError:
                    pass  # rank 0 then waits out TIMEOUT

    def _await_ranks(self, shards: str, world: int) -> None:
        """Rank 0: wait until every rank has marked its part of the save
        in ``shards``; raise if one failed, or none came by ``TIMEOUT``."""
        deadline = time.monotonic() + TIMEOUT.total_seconds()
        waiting, pause = set(range(world)), 0.002
        while waiting:
            for r in sorted(waiting):
                if os.path.exists(os.path.join(shards, f"{r}.failed")):
                    raise RuntimeError(f"rank {r} failed its write")
                if os.path.exists(os.path.join(shards, f"{r}.json")):
                    waiting.discard(r)
            if waiting:
                if time.monotonic() > deadline:
                    raise TimeoutError(f"ranks {sorted(waiting)} never "
                                       "finished their writes")
                time.sleep(pause)
                pause = min(2 * pause, 0.1)

    def _commit(self, name: str, world: int, meta: dict) -> None:
        """Rank 0, once every rank has written: the listings merged into
        ``index.json`` (each entry's pieces must fill it), files no entry
        names removed (the marks among them), then the rename into
        place."""
        tmp = self._tmp(name)
        shards = os.path.join(tmp, SHARDS)
        self._await_ranks(shards, world)
        entries: dict = {}
        for r in range(world):
            with open(os.path.join(shards, f"{r}.json")) as f:
                for rec in json.load(f):
                    e = entries.setdefault(rec["entry"], {})
                    if "value" in rec:
                        e["value"] = rec["value"]
                        continue
                    e.update(shape=rec["shape"], dtype=rec["dtype"])
                    e.setdefault("pieces", []).append({
                        k: rec[k] for k in ("file", "key", "offsets",
                                            "lengths")})
        files = set()
        for entry, e in entries.items():
            if "value" in e:
                continue
            n = sum(math.prod(p["lengths"]) for p in e["pieces"])
            if n != math.prod(e["shape"]):
                raise RuntimeError(f"{entry}: pieces of {n} elements for a "
                                   f"{tuple(e['shape'])} tensor")
            files.update(p["file"] for p in e["pieces"])
        for f in os.listdir(shards):
            if f"{SHARDS}/{f}" not in files:
                os.remove(os.path.join(shards, f))
        _write_json(os.path.join(tmp, INDEX_FILE),
                    {"world": world, "entries": entries})
        _write_json(os.path.join(tmp, META_FILE), meta)
        final, sidecar = self.path(name), self._sidecar(name)
        old = None
        if os.path.exists(final):
            # Never a sidecar beside contents it does not describe: it goes
            # first, and the old directory's own meta.json describes it
            # until the rename.
            if os.path.exists(sidecar):
                os.remove(sidecar)
            old = os.path.join(self.base, f".{name}.old")
            shutil.rmtree(old, ignore_errors=True)
            os.rename(final, old)
        os.rename(tmp, final)
        _write_json(sidecar, meta)
        if old is not None:
            shutil.rmtree(old, ignore_errors=True)

    def wait(self) -> None:
        """Block until the save in flight is on disk and committed (across
        processes: on every rank, until rank 0 has renamed it into place;
        the host all-reduce of the failures is the barrier); raise its
        error, or another rank's."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        err, self._error = self._error, None
        failed = err is not None
        if self._mesh is not None:
            failed = bool(host_all_reduce(self._mesh, [failed], "max")[0])
        if err is not None:
            raise RuntimeError("checkpoint write failed") from err
        if failed:
            raise RuntimeError("checkpoint write failed on another rank")

    # -- restore -----------------------------------------------------------
    def exists(self, name: str) -> bool:
        return os.path.isdir(self.path(name))

    def restore(self, name: str, trainer) -> None:
        """Load checkpoint ``name`` into ``trainer`` (its model, every
        entry, optimizer, schedule and step count), each rank its own
        pieces, whatever layout wrote it. Raises ``ValueError`` across the
        dense/MoE boundary."""
        self.wait()
        d = self.path(name)
        reader = PieceReader(d)
        saved = [e[len("model/"):] for e in reader.entries
                 if e.startswith("model/")]
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
        known = trainer._whole_names
        if set(saved) != set(known):
            raise RuntimeError(
                f"checkpoint {name}: missing "
                f"{sorted(set(known) - set(saved))}, unexpected "
                f"{sorted(set(saved) - set(known))}")
        trainer.load_model_pieces(known, reader.read)
        state = torch.load(os.path.join(d, TRAIN_STATE_FILE),
                           map_location="cpu", weights_only=True)
        trainer.load_optimizer_pieces(
            {e: r for e, r in reader.entries.items()
             if e.startswith("optimizer/")}, reader.read, state["hyper"])
        trainer.scheduler.load_state_dict(state["scheduler"])
        trainer.step = int(state["step"])
        self.files_read = list(reader.opened)

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
