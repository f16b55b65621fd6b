"""The multi-process branches of the port's ``train()`` over 2 gloo ranks on
the CPU (the port alone; ``tests/test_torch_ddp.py`` holds the losses to
JAX): a halt and its resume at 2 ranks, bitwise; a SIGTERM that reaches one
rank only; a 2-rank checkpoint resumed by one process; the per-rank cache
files; the cached-or-full and the bucket-width choices, which must be the
same on every rank; rank 0's outputs.

One torchrun job runs five ``train()`` calls one after another (tiny
geometry, fp32, kernel flags on, ``batch_size`` 4 per rank, 16 skewed
synthetic rows, so 2 updates an epoch): ``full`` (3 epochs, T5 dropout 0.1,
``cache_frozen_features``, ``bucket_lengths``, seed 18), ``halt`` (the same,
halting after update 3, mid-epoch 2) and ``resume`` (the same command
again), ``sigterm`` (rank 1 sends itself SIGTERM after update 1,
``preempt_sync_steps`` 2) and ``halt0`` (dropout 0, no cache, halting after
update 3), which one process then resumes at the same global batch. Seed 18
is one whose shuffles give the ranks different local bucket widths in some
update and, in another, a cache hit on one rank and a miss on the other
(``_simulate`` checks both before anything runs).
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import _torch_port as tp
from _torch_ddp_worker import Job, loaders
from klab_multimodalmodel_tpu_torch import config as tcfg
from klab_multimodalmodel_tpu_torch.data import (DataLoader,
                                                 SyntheticCaptionDataset)
from klab_multimodalmodel_tpu_torch.text import ByteTokenizer
from klab_multimodalmodel_tpu_torch.train import train
from klab_multimodalmodel_tpu_torch.train.loop import dropout_seed
from klab_multimodalmodel_tpu_torch.utils.bucketing import pow2_bucket_width

TOL = 1e-4
RANKS, BATCH, N_TRAIN, N_VAL, EPOCHS, SEED = 2, 8, 16, 8, 3, 18
T5_DROPOUT = "t5-torchport-tiny-dropout"
TINY_T5_DROPOUT = dict(tp.TINY_T5, dropout_rate=0.1)
tcfg.register_t5_size(T5_DROPOUT, tcfg.T5Size(**TINY_T5_DROPOUT))
SIZES = dict(t5_sizes={tp.T5_NAMES["v10"][0]: tp.TINY_T5,
                       T5_DROPOUT: TINY_T5_DROPOUT},
             swin_sizes={tp.SWIN_NAME: tp.TINY_SWIN})
RUN = dict(n_train=N_TRAIN, n_val=N_VAL, global_batch=BATCH)


def _config(root, tag, dropout=True, **kw):
    _, cfg = tp.configs(
        compute_dtype="float32", batch_size=BATCH // RANKS,
        num_epochs=EPOCHS, max_source_length=64, max_target_length=160,
        data_dir="synthetic", seed=SEED, result_dir=str(root / tag), **kw)
    if dropout:
        cfg = dataclasses.replace(cfg, language_model_name=T5_DROPOUT,
                                  transformer_model_name=T5_DROPOUT)
    return cfg


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    root = tmp_path_factory.mktemp("ddp_loop")
    opts = dict(cache_frozen_features=True, bucket_lengths=True)
    specs = {
        "full": _config(root, "full", **opts),
        "halt": _config(root, "resumed", halt_after_steps=3, **opts),
        "resume": _config(root, "resumed", halt_after_steps=3, **opts),
        "sigterm": _config(root, "sigterm", preempt_sync_steps=2),
        "halt0": _config(root, "elastic", dropout=False,
                         halt_after_steps=3),
    }
    runs = [dict(RUN, config=dataclasses.asdict(cfg),
                 out=str(root / f"{tag}.{{rank}}.json"),
                 params=str(root / f"{tag}.{{rank}}.pt"),
                 sigterm_after={"1": 1} if tag == "sigterm" else None)
            for tag, cfg in specs.items()]
    results = Job(root, runs, SIZES).results()
    out = {tag: dict(ranks=ranks, config=specs[tag],
                     params=[torch.load(str(root / f"{tag}.{r}.pt"))
                             for r in range(RANKS)])
           for tag, ranks in zip(specs, results)}
    out["root"] = root
    return out


def _checkpoints(cfg):
    return os.path.join(cfg.result_dir, "checkpoints")


def test_halt_and_resume_at_two_ranks_is_bitwise(job):
    """``halt`` stops both ranks after update 3 with ``step_3`` (each
    rank's generator state in its metadata); ``resume`` equals ``full``
    bitwise: losses, min_val_loss, steps and every parameter."""
    for r in range(RANKS):
        halted = job["halt"]["ranks"][r]
        assert halted["halted"] and halted["steps"] == 3
        full, resumed = job["full"]["ranks"][r], job["resume"]["ranks"][r]
        assert not resumed["halted"]
        assert resumed["losses"] == full["losses"]
        assert resumed["min_val_loss"] == full["min_val_loss"]
        assert resumed["steps"] == full["steps"] == EPOCHS * 2
        for name, p in job["full"]["params"][r].items():
            assert torch.equal(job["resume"]["params"][r][name], p), name
    with open(os.path.join(_checkpoints(job["halt"]["config"]),
                           "step_3.meta.json")) as f:
        meta = json.load(f)
    states = meta["generator_states"]
    assert len(states) == RANKS and states[0] != states[1]
    assert meta["generator_state"] == states[0]
    assert meta["epoch"] == 1 and meta["epoch_cursor"] == 1
    seeds = [r["generator_seed"] for r in job["full"]["ranks"]]
    assert seeds == [dropout_seed(SEED, r) for r in range(RANKS)]
    assert seeds[0] == SEED + 1 and seeds[0] % 2**32 != seeds[1] % 2**32


def test_sigterm_on_one_rank_halts_both(job):
    """Rank 1 alone sees SIGTERM after update 1; with preempt_sync_steps
    2 both ranks halt after update 2, and step_2 is saved (by rank 0)."""
    ranks = job["sigterm"]["ranks"]
    assert [(r["halted"], r["steps"]) for r in ranks] == [(True, 2)] * 2
    assert ranks[0]["saves"] == ["step_2"] and ranks[1]["saves"] == []
    base = _checkpoints(job["sigterm"]["config"])
    assert os.path.isdir(os.path.join(base, "step_2"))
    assert os.path.exists(os.path.join(base, "step_2.meta.json"))


def test_two_rank_checkpoint_resumes_in_one_process(job):
    """``halt0``'s step_3, written by 2 ranks, resumed by one process at
    the same global batch: it ends where one uninterrupted process ends
    (losses, min_val_loss, steps, parameters); the frozen towers are the
    checkpoint's, bitwise."""
    cfg = dataclasses.replace(job["halt0"]["config"], batch_size=BATCH,
                              halt_after_steps=0)
    resumed = train(cfg, *loaders(cfg, RUN, 0, 1), device="cpu")
    assert not resumed["halted"]
    ref_cfg = dataclasses.replace(
        cfg, result_dir=str(job["root"] / "elastic_ref"))
    ref = train(ref_cfg, *loaders(ref_cfg, RUN, 0, 1), resume=False,
                device="cpu")
    assert resumed["steps"] == ref["steps"] == EPOCHS * 2
    for phase in ("train", "val"):
        np.testing.assert_allclose(resumed["losses"][phase],
                                   ref["losses"][phase], rtol=TOL)
    assert resumed["min_val_loss"] == pytest.approx(ref["min_val_loss"],
                                                    rel=TOL)
    ref_params = dict(ref["trainer"].model.named_parameters())
    for name, p in resumed["trainer"].model.named_parameters():
        if p.requires_grad:
            np.testing.assert_allclose(p.detach().numpy(),
                                       ref_params[name].detach().numpy(),
                                       rtol=TOL, atol=1e-6, err_msg=name)
        else:
            assert torch.equal(p, job["halt0"]["params"][0][name]), name


def test_per_rank_cache_files(job):
    cache = os.path.join(job["full"]["config"].result_dir, "feature_cache")
    names = set(os.listdir(cache))
    for tag in ("train", "val"):
        for kind in ("img", "lang"):
            for r in range(RANKS):
                for suffix in ("", ".mask.npy", ".meta.json"):
                    assert f"{tag}.{kind}.feat.p{r}{suffix}" in names
            assert f"{tag}.{kind}.feat" not in names


def _simulate():
    """Per update of ``full``: each rank's own bucket width and cache hit
    (a full step's rows are readable two updates later, or after the
    epoch), from the loaders' orders."""
    ds = SyntheticCaptionDataset(n=N_TRAIN, image_size=32, skew=True)
    tok = ByteTokenizer()
    mask = tok([ds[i][2] for i in range(N_TRAIN)],
               max_length=160).attention_mask
    ldrs = [DataLoader(ds, tok, BATCH, shuffle=True, seed=SEED,
                       process_index=r, process_count=RANKS)
            for r in range(RANKS)]
    cache = [set() for _ in range(RANKS)]
    widths, hits, cached = [], [], []
    for epoch in range(1, EPOCHS + 1):
        order = []
        for ldr in ldrs:
            ldr.set_epoch(epoch)
            order.append(ldr.epoch_indices())
        pending = []
        for b in range(len(ldrs[0])):
            for item in [p for p in pending if p[0] <= b]:
                cache[item[1]] |= item[2]
                pending.remove(item)
            rows = [set(order[r][b].tolist()) for r in range(RANKS)]
            widths.append([pow2_bucket_width(mask[order[r][b]], 8)
                           for r in range(RANKS)])
            hits.append([rows[r] <= cache[r] for r in range(RANKS)])
            cached.append(all(hits[-1]))
            if not cached[-1]:
                pending += [(b + 2, r, rows[r]) for r in range(RANKS)]
        for _, r, rows in pending:
            cache[r] |= rows
    return widths, hits, cached


def test_cached_or_full_is_one_choice(job):
    """Every update takes the cached step on both ranks or on neither, as
    the simulated caches say; in one update one rank alone would have hit."""
    _, hits, cached = _simulate()
    assert any(len(set(h)) > 1 for h in hits)
    logs = [r["step_log"] for r in job["full"]["ranks"]]
    for r in range(RANKS):
        assert [s["cached"] for s in logs[r]] == cached


def test_bucket_widths_agree(job):
    """Each update's target width is the widest rank's bucket on both
    ranks; in some update the ranks' own buckets differ."""
    widths, _, _ = _simulate()
    assert any(len(set(w)) > 1 for w in widths)
    for r in range(RANKS):
        got = [s["target_width"] for s in job["full"]["ranks"][r]["step_log"]]
        assert got == [max(w) for w in widths]


def test_rank0_only_outputs(job):
    """One metrics.jsonl line per epoch, train.log and config.json written
    once (rank 0), the checkpoints saved by rank 0 alone."""
    d = job["full"]["config"].result_dir
    with open(os.path.join(d, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert [row["epoch"] for row in rows] == list(range(1, EPOCHS + 1))
    ranks = job["full"]["ranks"]
    assert [row["train_loss"] for row in rows] == ranks[0]["losses"]["train"]
    assert os.path.exists(os.path.join(d, "train.log"))
    assert os.path.exists(os.path.join(d, "config.json"))
    assert ranks[0]["saves"] and ranks[1]["saves"] == []
    assert ranks[0]["losses"] == ranks[1]["losses"]
