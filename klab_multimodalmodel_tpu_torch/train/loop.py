"""The training loop: epochs, validation, checkpoints, logging.

The JAX package's ``train()``, on one card or on one DDP rank per card (the
reference's ``torchrun --nproc_per_node W``), which keeps the reference's
control flow:
  * epochs from ``num_steps`` as ``int(num_steps / len(loader)) + 1``;
  * ``min_val_loss`` starts at the literal 100;
  * a ``best`` save on each improvement of the validation loss, and
    interval saves named ``epoch_N`` / ``step_N`` (the step mode checked once
    per epoch, as the reference checks it);
  * per-epoch mean train and val losses, logged, appended to
    ``metrics.jsonl`` and plotted to ``loss.png``.

Beyond the reference, as in the JAX package: epoch-seeded shuffling, losses
kept on the device until an epoch closes, gradient accumulation with a
gradient-exact ragged tail, full-state checkpoints with a resume that equals
the uninterrupted run bitwise (mid-epoch too: ``halt_after_steps`` and
SIGTERM), power-of-two length buckets, the frozen-feature cache
(``cache_frozen_features``), and every ``eval_captions_every`` epochs the
CIDEr-D / BLEU-4 / ROUGE-L of the first ``eval_captions_limit`` COCO-val
images (logged, TensorBoard ``quality/*``, and the epoch's
``metrics.jsonl`` row).

Across processes (a process group: ``utils/mesh.py``) the loop takes the
JAX package's multi-process branches. A data rank is an index over data x
fsdp (``Mesh.dp_rank``): the ranks of one tensor, seq, pipe or expert
group share it,
draw the same rows and the same dropout stream. Rank 0 alone saves the config, logs
at INFO, writes TensorBoard, the profile, ``metrics.jsonl``, ``loss.png``
and the checkpoints; each process keeps its own feature-cache files
(``.p{rank}``, the world rank). What decides a step's shape or
kind, or whether to stop, is agreed over the host's gloo group: the bucket
widths (the largest over the ranks), the cached or full step and the image
decode skip (all ranks must hit), a halt (SIGTERM seen by any rank, agreed
every ``preempt_sync_steps`` updates). The losses are all-reduced, so the
ranks agree on ``min_val_loss`` and the ``best`` save too. The ranks meet at
a barrier before the first step; with the kernels on a cold build, rank 0
builds them while the others wait there. Loaders passed in must draw this
rank's chunk (``process_index`` / ``process_count``).

Dropout draws from one ``torch.Generator`` per data rank on the rank's
device, seeded with ``dropout_seed(seed, rank)``: ``seed + 1`` on rank 0 (the JAX
package's dropout key, so one process draws what it always drew), mixed
with the rank elsewhere, in the low 32 bits too (the CPU generator reads
only those): the ranks' masks differ, where one shared seed would repeat
rank 0's masks on every rank's own rows. Every checkpoint records each data
rank's generator state between updates (gathered to rank 0:
``generator_states``,
and rank 0's as ``generator_state``), so a resume at the same world size
equals the uninterrupted run bitwise; at another world size, a rank with no
recorded state starts its seeded stream afresh.
"""

from __future__ import annotations

import json
import os
import signal
import time
from typing import Optional, Union

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..checkpoint.io import CheckpointManager, load_pretrained_params
from ..config import Config
from ..data.pipeline import DataLoader, get_dataloader
from ..evaluation.evaluate import coco_references, evaluate_captions
from ..obs import profiler
from ..obs.logger import get_logger
from ..obs.metrics import LossCounter
from ..obs.tb import ScalarWriter
from ..text.tokenizer import load_tokenizer
from ..utils.bucketing import pow2_bucket_width
from ..utils.mesh import (barrier, host_all_reduce, make_mesh,
                          maybe_init_distributed, rank_device)
from .feature_cache import FrozenFeatureCache, swin_feature_shape
from .optim import make_lr_schedule
from .trainer import Trainer


def dropout_seed(seed: int, rank: int) -> int:
    """The seed of data rank ``rank``'s dropout generator."""
    return (seed + 1) ^ ((rank * 0x9E3779B97F4A7C15) & (2 ** 63 - 1))


def train(config: Config,
          train_loader: Optional[DataLoader] = None,
          val_loader: Optional[DataLoader] = None,
          resume: bool = True, *,
          device: Optional[Union[str, torch.device]] = None) -> dict:
    """Run training; returns a summary (the trainer, the loss history,
    steps, ``min_val_loss``, ``halted``, the checkpoint saves, the
    dropout generator). ``device``: None means the card (under torchrun,
    ``cuda:LOCAL_RANK``). Joins the job's process group if the environment
    names one of several processes and none exists yet. Resumes from the
    most advanced ``epoch_N`` / ``step_N`` checkpoint in ``result_dir``
    when ``resume``."""
    device = rank_device(device)
    maybe_init_distributed(device)
    mesh = make_mesh(config.mesh_shape, config.mesh_axis_names,
                     config.dcn_mesh_shape)
    # The data rank and the data ranks (data x fsdp).
    rank, world = mesh.dp_rank, mesh.dp_size
    is_main = mesh.rank == 0
    logger = get_logger(config.result_dir)
    if is_main:
        config.save()
    logger.info(config)
    if config.eval_captions_every and mesh.distributed:
        raise ValueError(
            "eval_captions_every supports single-process runs only "
            "(caption decode is not sharded across processes); run "
            "the eval command after training instead")

    tokenizer = load_tokenizer(config.tokenizer_path)
    owned = []  # loaders made here, whose decode pools finish() shuts down
    if train_loader is None:
        train_loader = get_dataloader(config, "train", tokenizer)
        owned.append(train_loader)
    if val_loader is None:
        val_loader = get_dataloader(config, "val", tokenizer)
        owned.append(val_loader)
    for loader in (train_loader, val_loader):
        if (loader.process_index, loader.process_count) != (rank, world):
            raise ValueError(
                f"a loader draws chunk {loader.process_index} of "
                f"{loader.process_count}, but this is rank {rank} of {world}")

    num_epochs = config.num_epochs
    if num_epochs is None:
        if config.num_steps is None:
            raise ValueError("set num_epochs or num_steps")
        num_epochs = int(config.num_steps / len(train_loader)) + 1

    accum = max(config.accumulation_steps, 1)
    tail = len(train_loader) % accum
    if tail and config.accumulation_tail == "error":
        raise ValueError(
            f"len(train_loader)={len(train_loader)} is not divisible by "
            f"accumulation_steps={accum} and accumulation_tail='error'; "
            "use 'pad' (gradient-exact partial update) or 'drop'")
    if tail and config.accumulation_tail == "pad" and config.reference_pad_quirks:
        raise ValueError(
            "accumulation_tail='pad' zero-weights the padding rows, but "
            "reference_pad_quirks keeps every position in the loss: the "
            "combination cannot be exact. Use accumulation_tail='drop' or "
            "make len(train_loader) divisible by accumulation_steps")
    if config.accumulation_tail == "drop" and len(train_loader) < accum:
        raise ValueError(
            f"len(train_loader)={len(train_loader)} < accumulation_steps="
            f"{accum} with accumulation_tail='drop': every epoch would "
            "drop all its batches and perform ZERO optimizer updates. Use "
            "accumulation_tail='pad', lower accumulation_steps, or grow "
            "the dataset/batch split")
    if config.accumulation_tail == "pad":
        opt_steps_per_epoch = max(-(-len(train_loader) // accum), 1)
    else:
        opt_steps_per_epoch = max(len(train_loader) // accum, 1)

    if (mesh.distributed and device.type == "cuda" and (
            config.use_pallas_attention or config.use_pallas_t5_attention)):
        # A cold tree builds the kernels once, on rank 0, not W times.
        if is_main:
            from ..ops import cuda_build

            cuda_build.build_all()
        barrier(mesh)
    trainer = Trainer(config, num_epochs=num_epochs, device=device,
                      mesh=mesh)
    # Seeded with config.seed on the device: every rank builds the same.
    trainer.init_state(global_batch=train_loader.global_batch_size)
    n_params = sum(p.numel() for p in trainer.model.parameters())
    logger.info(f"model parameters: {n_params:,}")

    ckpt = CheckpointManager(config.result_dir, mesh)
    start_epoch = 1
    steps = 0
    min_val_loss = 100  # the reference's literal
    resume_meta: dict = {}
    latest = ckpt.latest() if resume else None
    if latest is not None:
        ckpt.restore(latest, trainer)
        resume_meta = ckpt.load_metadata(latest) or {}
        start_epoch = int(resume_meta.get("epoch", 0)) + 1
        steps = int(resume_meta.get("steps", trainer.step))
        min_val_loss = float(resume_meta.get("min_val_loss", 100))
        logger.info(
            f"resumed from {latest} (epoch {start_epoch - 1}, "
            f"cursor {int(resume_meta.get('epoch_cursor', 0))})")
    elif config.init_checkpoint:
        loaded = load_pretrained_params(config.init_checkpoint, trainer)
        logger.info(f"initialized {', '.join(loaded)} from pretrained "
                    f"{config.init_checkpoint}")

    loss_counter = LossCounter(opt_steps_per_epoch, max(len(val_loader), 1))
    generator = torch.Generator(device=trainer.device).manual_seed(
        dropout_seed(config.seed, rank))
    # An exact resume restores the generators, the epoch's cursor (update
    # groups done) and the loss partials that every checkpoint records.
    resume_cursor = int(resume_meta.get("epoch_cursor", 0))
    gen_states = resume_meta.get("generator_states") or (
        [resume_meta["generator_state"]]
        if resume_meta.get("generator_state") is not None else [])
    if rank < len(gen_states):
        generator.set_state(torch.tensor(gen_states[rank],
                                         dtype=torch.uint8))
    if resume_meta.get("loss_counter") is not None:
        loss_counter.load_state_dict(resume_meta["loss_counter"])

    tb = ScalarWriter(os.path.join(config.result_dir, "tb")
                      if config.tensorboard and is_main else None)
    lr_schedule = make_lr_schedule(config, max(num_epochs or 1, 1))
    prof = profiler.StepWindowTrace(
        config.result_dir, config.profile_steps if is_main else 0)

    # Frozen-feature caches (cache_frozen_features): epoch 1 fills them from
    # the normal step's tower outputs; later epochs skip the image tower,
    # and the text tower too when the dataset's source text is static
    # (caption prompts; span corruption re-masks per epoch). The towers are
    # deterministic, so the losses are unchanged.
    train_cache = val_cache = None
    if config.cache_frozen_features:
        img_shape = swin_feature_shape(config)
        lang_shape = (config.max_source_length, config.language_t5.d_model)
        cache_dir = os.path.join(config.result_dir, "feature_cache")
        # Each rank owns its files (a memmap has no second writer); rows
        # that a reshuffle moves to another rank miss there and refill.
        proc_tag = f".p{mesh.rank}" if mesh.distributed else ""

        def make_caches(tag, loader):
            caches = {"img": FrozenFeatureCache(
                os.path.join(cache_dir, f"{tag}.img.feat{proc_tag}"),
                len(loader.dataset), img_shape, dtype=config.compute_dtype)}
            if getattr(loader.dataset, "source_is_static", False):
                caches["lang"] = FrozenFeatureCache(
                    os.path.join(cache_dir, f"{tag}.lang.feat{proc_tag}"),
                    len(loader.dataset), lang_shape,
                    dtype=config.compute_dtype)
            return caches

        train_cache = make_caches("train", train_loader)
        val_cache = make_caches("val", val_loader)

    def cache_lookup(caches, batch, index):
        """The batch with cached features in place of the images if every
        row is cached, else None."""
        if not caches["img"].has(index):
            return None
        fb = {k: v for k, v in batch.items() if k != "images"}
        fb["image_features"] = caches["img"].get(index)
        if "lang" in caches:
            if not caches["lang"].has(index):
                return None
            # The cache holds max_source_length rows; follow the batch's
            # (possibly bucketed) source width.
            fb["language_features"] = (
                caches["lang"].get(index)[:, :fb["source_mask"].shape[1]])
        return fb

    def bucket_batch(batch):
        """Trim source/target pad columns to the smallest power-of-two
        width that holds the longest row (bucket_lengths); loss-identical,
        since pads are masked out."""
        if not config.bucket_lengths:
            return batch
        # Each rank sees its own rows: the widest bucket of any rank.
        sb, tb_ = host_all_reduce(
            mesh, [pow2_bucket_width(batch["source_mask"], 16),
                   pow2_bucket_width(batch["target_mask"], 8)], "max")
        out = dict(batch)
        for k, b in (("source_ids", sb), ("source_mask", sb),
                     ("target_ids", tb_), ("target_mask", tb_)):
            out[k] = np.ascontiguousarray(batch[k][:, :b])
        return out

    def cache_fill(caches, index, copy):
        img, lang = copy.wait()
        caches["img"].put(index, img)
        if "lang" in caches:
            full = caches["lang"].feature_shape[0]
            if lang.shape[1] < full:
                # bucket_lengths trimmed pad columns: zeros there are
                # equivalent, every attention read masks pad positions.
                lang = F.pad(lang, (0, 0, 0, full - lang.shape[1]))
            caches["lang"].put(index, lang)

    # Fills are deferred by one step: a step's features start their copy to
    # the host behind it, and are written to the cache after the NEXT step
    # is enqueued, so the wait and the memmap write overlap device work.
    pending_fill: list = []

    def drain_fills():
        while pending_fill:
            cache_fill(*pending_fill.pop(0))

    def flush_caches():
        """Drain deferred fills, then persist data and fill masks: the one
        path for the epoch's end and the halt save."""
        drain_fills()
        if train_cache is not None:
            for c in (*train_cache.values(), *val_cache.values()):
                c.flush()

    def all_ranks_agree(flag: bool) -> bool:
        """True when every rank's ``flag`` is: which step runs is one
        choice for all, or their collectives would part ways."""
        return bool(host_all_reduce(mesh, [flag], "min")[0])

    def step_with_cache(caches, batch, index, run_cached, run_full):
        """From the cache when every row of every rank is cached; else the
        step that also returns the towers' features, whose fill is
        deferred."""
        if caches is not None and index is not None:
            fb = cache_lookup(caches, batch, index)
            if not all_ranks_agree(fb is not None):
                fb = None
            if fb is not None:
                loss = run_cached(trainer.to_device(fb))
                drain_fills()
                return loss
            loss, feats = run_full(trainer.to_device(batch))
            copy = trainer.copy_to_host(feats)
            drain_fills()  # the previous step's; the device is busy now
            pending_fill.append((caches, index, copy))
            return loss
        return run_cached(trainer.to_device(batch))

    def set_skip_image_load(caches, loader):
        """An epoch whose every row is in every cache of every rank skips
        the image decode: the cached step never reads the pixels (call
        after set_epoch)."""
        if caches is not None:
            rows = loader.epoch_indices().reshape(-1)
            loader.dataset.skip_image_load = all_ranks_agree(all(
                c.has(rows) for c in caches.values()))

    # -- halts ---------------------------------------------------------------
    # "local": this rank saw SIGTERM; "global": the ranks agreed to halt.
    # Every rank must reach the halt save at the same update, so the local
    # flag is shared every preempt_sync_steps updates (one process: each).
    halted = {"local": False, "global": False}
    prev_sigterm = None
    if config.save_on_sigterm:
        try:
            prev_sigterm = signal.signal(
                signal.SIGTERM,
                lambda *_: halted.__setitem__("local", True))
        except ValueError:
            prev_sigterm = None  # not the main thread: no handler

    # A threshold the resumed step count has already passed is spent:
    # rerunning the same command must continue to the end, not halt again.
    halt_threshold = (config.halt_after_steps
                      if config.halt_after_steps > steps else 0)

    def should_halt() -> bool:
        if not mesh.distributed:
            halted["global"] = halted["local"]
        elif steps % max(config.preempt_sync_steps, 1) == 0:
            halted["global"] = bool(
                host_all_reduce(mesh, [halted["local"]], "max")[0])
        return bool((halt_threshold and steps >= halt_threshold)
                    or halted["global"])

    def resume_state_meta() -> dict:
        """Generator and loss-partial fields of every checkpoint's
        metadata, so that any resume is exact (every rank calls it)."""
        state = generator.get_state().tolist()
        meta = {"generator_state": state,
                "loss_counter": loss_counter.state_dict()}
        if mesh.distributed:
            states = [None] * dist.get_world_size()
            dist.all_gather_object(states, state, group=mesh.cpu_group)
            # One per data rank: a tensor x seq x pipe x expert block
            # holds one stream.
            states = states[::mesh.rows_share]
            meta["generator_state"] = states[0]
            meta["generator_states"] = states
        return meta

    def finish(summary_extra: dict) -> dict:
        ckpt.wait()
        prof.close()
        tb.close()
        for loader in owned:
            loader.close()
        if prev_sigterm is not None:
            signal.signal(signal.SIGTERM, prev_sigterm)
        return {"trainer": trainer, "losses": loss_counter.losses,
                "min_val_loss": min_val_loss, "steps": steps,
                "saves": ckpt.saves, "generator": generator,
                **summary_extra}

    eval_refs = None  # (paths, references) of COCO val, read once

    def eval_captions(refs) -> dict:
        """Caption the first ``eval_captions_limit`` val images with the
        trainer's own model (in fp32, as a ``Captioner`` computes) and
        score them. Draws nothing from the step generator, and puts the
        model back in training mode."""
        try:
            with profiler.annotate("eval_captions"):
                return evaluate_captions(
                    config, trainer.model, tokenizer, refs[0], refs[1],
                    limit=config.eval_captions_limit, device=trainer.device)
        finally:
            trainer.model.train()

    barrier(mesh)  # the ranks start their first step together
    for epoch in range(start_epoch, num_epochs + 1):
        train_loader.set_epoch(epoch)
        set_skip_image_load(train_cache, train_loader)
        epoch_t0 = time.perf_counter()
        images_seen = 0
        groups_done = 0
        start_batch = 0
        if epoch == start_epoch and resume_cursor:
            # Mid-epoch resume: replay this epoch's order from the cursor.
            groups_done = resume_cursor
            start_batch = resume_cursor * accum

        def run_update(merged, n_real_images):
            nonlocal steps, images_seen
            prof.tick()
            merged = bucket_batch(merged)
            index = merged.pop("index", None)

            def run_cached(db):
                name = ("train_step_cached" if "image_features" in db
                        else "train_step")
                with profiler.annotate(name):
                    return trainer.train_step(db, generator)

            def run_full(db):
                with profiler.annotate("train_step"):
                    return trainer.train_step_with_features(db, generator)

            loss = step_with_cache(train_cache, merged, index,
                                   run_cached, run_full)
            loss_counter.add_loss("train", loss)
            steps += 1
            # Every rank draws an equal chunk of each global batch.
            images_seen += n_real_images * world
            if config.log_every_steps and steps % config.log_every_steps == 0:
                dt_so_far = time.perf_counter() - epoch_t0
                logger.info(f"step {steps}: "
                            f"{images_seen / dt_so_far:.1f} img/s")

        def preempt_save() -> dict:
            """Save step_N with the epoch's cursor, the generator and the
            loss partials, and stop; rerunning resumes exactly."""
            flush_caches()
            meta = {"epoch": epoch - 1, "steps": steps,
                    "min_val_loss": min_val_loss,
                    "epoch_cursor": groups_done, **resume_state_meta()}
            ckpt.save(f"step_{steps}", trainer, meta)
            logger.info(f"halt: saved step_{steps} (epoch {epoch} cursor "
                        f"{groups_done}); rerun to resume")
            return finish({"halted": True})

        micro_group: list = []
        for batch in train_loader.iter_from(start_batch):
            micro_group.append(batch)
            if len(micro_group) < accum:
                continue
            merged = {k: np.concatenate([m[k] for m in micro_group])
                      for k in micro_group[0]}
            micro_group = []
            run_update(merged, merged["images"].shape[0])
            groups_done += 1
            if should_halt():
                return preempt_save()
        if micro_group and config.accumulation_tail == "pad":
            # Ragged final update: pad the leftover microbatches to a full
            # group by cycling real rows with both masks zeroed. Zero target
            # weights make their loss and gradients exactly zero, so this
            # equals the reference's smaller final group. Under MoE the
            # zeroed masks (the image tokens follow the source row's) keep
            # the phantom rows out of routing, capacity and the balance
            # loss's group mean. Phantom index rows are -1, so the cache
            # never stores their features.
            real = {k: np.concatenate([m[k] for m in micro_group])
                    for k in micro_group[0]}
            n_real = real["images"].shape[0]
            micro_rows = n_real // len(micro_group)
            n_total = accum * micro_rows
            idx = np.arange(n_total) % n_real
            merged = {k: v[idx] for k, v in real.items()}
            for k in ("target_mask", "source_mask"):
                merged[k] = merged[k].copy()
                merged[k][n_real:] = 0
            if "index" in merged:
                merged["index"] = merged["index"].copy()
                merged["index"][n_real:] = -1
            run_update(merged, n_real)
            groups_done += 1
            if should_halt():
                return preempt_save()
        # (accumulation_tail 'drop': the leftovers are skipped.)

        set_skip_image_load(val_cache, val_loader)
        for batch in val_loader:
            batch = bucket_batch(batch)
            index = batch.pop("index", None)
            loss = step_with_cache(val_cache, batch, index,
                                   trainer.eval_step,
                                   trainer.eval_step_with_features)
            loss_counter.add_loss("val", loss)
        flush_caches()

        # All-reduced, so equal on every rank: every rank takes the same
        # ``best`` branch.
        train_loss, val_loss = loss_counter.count_and_get_loss()
        dt = time.perf_counter() - epoch_t0
        ips = images_seen / dt if dt > 0 else 0.0
        lr = float(lr_schedule(max(steps - 1, 0)))  # at the epoch's last update
        caption_scores = None
        if (config.eval_captions_every
                and epoch % config.eval_captions_every == 0):
            if eval_refs is None:
                eval_refs = coco_references(config.data_dir, "val")
            caption_scores = eval_captions(eval_refs)
            logger.info(
                f"[Epoch ({epoch}/{num_epochs})] CIDEr-D : "
                f"{caption_scores['CIDEr-D']:.3f}, BLEU-4 : "
                f"{caption_scores['BLEU-4']:.4f}, ROUGE-L : "
                f"{caption_scores['ROUGE-L']:.4f} "
                f"({caption_scores['num_images']} images)")
            if tb.enabled:
                tb.scalar("quality/cider_d", caption_scores["CIDEr-D"], epoch)
                tb.scalar("quality/bleu4", caption_scores["BLEU-4"], epoch)
                tb.scalar("quality/rouge_l", caption_scores["ROUGE-L"], epoch)
        if tb.enabled:
            tb.scalar("loss/train", train_loss, epoch)
            tb.scalar("loss/val", val_loss, epoch)
            tb.scalar("throughput/img_per_sec", ips, epoch)
            tb.scalar("lr", lr, epoch)
        logger.info(f"[Epoch ({epoch}/{num_epochs})] Train loss : "
                    f"{train_loss}, Val loss : {val_loss} ({ips:.1f} img/s)")
        # One JSON line per epoch, appended: a resumed run extends it.
        row = {"epoch": epoch, "steps": steps, "train_loss": train_loss,
               "val_loss": val_loss, "img_per_sec": round(ips, 2), "lr": lr,
               "epoch_seconds": round(dt, 2)}
        if caption_scores is not None:
            row["cider_d"] = caption_scores["CIDEr-D"]
            row["bleu4"] = caption_scores["BLEU-4"]
        if is_main:
            with open(os.path.join(config.result_dir, "metrics.jsonl"),
                      "a") as f:
                f.write(json.dumps(row) + "\n")

        meta = {"epoch": epoch, "steps": steps,
                "min_val_loss": min_val_loss, "epoch_cursor": 0,
                "train_loss": train_loss, "val_loss": val_loss,
                **resume_state_meta()}
        if val_loss < min_val_loss:
            min_val_loss = val_loss
            meta["min_val_loss"] = min_val_loss
            logger.info("Best Model saving...")
            ckpt.save("best", trainer, meta)
            logger.info("Best Model saved")

        if config.save_interval is not None:
            if config.num_steps is None:
                if epoch % config.save_interval == 0:
                    ckpt.save(f"epoch_{epoch}", trainer, meta)
                    logger.info(f"Model epoch_{epoch} saved")
            elif steps % config.save_interval == 0:
                # The reference checks the step interval once per epoch.
                ckpt.save(f"step_{steps}", trainer, meta)
                logger.info(f"Model step_{steps} saved")

    if is_main:
        try:
            loss_counter.plot_loss(config.result_dir)
        except ImportError:
            logger.info("loss.png not written: matplotlib is not installed "
                        "(metrics.jsonl holds the same curve)")
    return finish({"halted": False})
