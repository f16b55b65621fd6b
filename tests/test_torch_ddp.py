"""Data-parallel ``train()`` of the port over 2 gloo ranks on the CPU,
launched as the reference launches it (``torch.distributed.run``), against
the JAX package's ``train()`` on the same weights and data, and against the
port's own one-process run.

Set-up: the tiny geometry of ``tests/_torch_port.py``, fp32, dropout 0,
kernel flags off (their parity has its own tests), ``batch_size`` 4 per rank
(global 8, ``BATCH`` of ``tests/test_torch_train_loop.py``'s JAX run over its
8 virtual devices), ``accumulation_steps`` 2 over a loader of 3 batches (the
second update of each epoch is the ragged 'pad' tail), ``bucket_lengths``,
and the skewed synthetic captions ("A dog." beside ~130-byte captions), so
that the two ranks' halves of a microbatch hold very different numbers of
target tokens. All three start from the JAX ``init_state`` parameters (the
port through ``init_checkpoint``). Losses, ``min_val_loss`` and steps agree
with JAX within ``TOL``; with the one-process port run, the final
parameters too. A mean of the ranks' own means (DDP's plain average) would
miss the first update's loss by far more than ``TOL``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import _torch_port as tp
from _torch_ddp_worker import Job, StepLog, loaders
from klab_multimodalmodel_tpu.checkpoint.io import (
    CheckpointManager as JaxCheckpointManager)
from klab_multimodalmodel_tpu.data import DataLoader as JaxDataLoader
from klab_multimodalmodel_tpu.data import (
    SyntheticCaptionDataset as JaxSynthetic)
from klab_multimodalmodel_tpu.text import ByteTokenizer as JaxByteTokenizer
from klab_multimodalmodel_tpu.train import Trainer as JaxTrainer
from klab_multimodalmodel_tpu.train import train as jax_train
from klab_multimodalmodel_tpu_torch.checkpoint.from_jax import (
    convert_jax_params)
from klab_multimodalmodel_tpu_torch.checkpoint.io import save_pretrained
from klab_multimodalmodel_tpu_torch.train import Trainer, train

TOL = 1e-4
BATCH = 8  # global: 2 ranks x 4; the JAX run's 8 virtual devices x 1
RANKS = 2
N_TRAIN, N_VAL = 24, 16
SIZES = dict(t5_sizes={tp.T5_NAMES["v10"][0]: tp.TINY_T5},
             swin_sizes={tp.SWIN_NAME: tp.TINY_SWIN})


def _configs(root):
    kw = dict(compute_dtype="float32", batch_size=1, num_epochs=2,
              max_source_length=64, max_target_length=80,
              data_dir="synthetic", accumulation_steps=2,
              bucket_lengths=True)
    jc, tc = tp.configs(kernels=False, **kw)
    jc = dataclasses.replace(jc, scan_unroll=1, result_dir=str(root / "jax"))
    return jc, tc


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX run, the port's 2-rank job and its one-process run, from the
    same initial parameters and data. The JAX run takes the parameters of
    its ``Trainer.init_state`` from ``jax_multimodal_params`` (the same
    values, traced once instead of twice), and its checkpoint writes are
    skipped: nothing here reads them, and orbax's first save alone costs
    ~12 s on the CPU."""
    root = tmp_path_factory.mktemp("ddp")
    jc, tc = _configs(root)
    params = tp.jax_multimodal_params(jc, jc.seed)
    save_pretrained(str(root / "init"), convert_jax_params(params, tc))
    tc = dataclasses.replace(tc, init_checkpoint=str(root / "init"))

    # The 2-rank job runs in its own processes while JAX trains here.
    run = dict(n_train=N_TRAIN, n_val=N_VAL, global_batch=BATCH)
    ddp_cfg = dataclasses.replace(tc, batch_size=BATCH // RANKS,
                                  result_dir=str(root / "ddp"))
    job = Job(root, [dict(
        run, config=dataclasses.asdict(ddp_cfg),
        out=str(root / "ddp.{rank}.json"),
        params=str(root / "ddp.{rank}.pt"))], SIZES)

    def make(n, shuffle):
        return JaxDataLoader(
            JaxSynthetic(n=n, image_size=jc.swin.image_size, skew=True),
            JaxByteTokenizer(), global_batch_size=BATCH,
            max_source_length=jc.max_source_length,
            max_target_length=jc.max_target_length, shuffle=shuffle, seed=0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxCheckpointManager, "save", lambda *a, **k: None)
        mp.setattr(JaxTrainer, "init_state",
                   lambda trainer, *_: tp.jax_train_state(trainer, params))
        jout = jax_train(jc, make(N_TRAIN, True), make(N_VAL, False),
                         resume=False)

    one_cfg = dataclasses.replace(tc, batch_size=BATCH,
                                  result_dir=str(root / "one"))
    # The one-process reference at torch's default thread count: its
    # elementwise bound below was set against that run's sums.
    with StepLog() as log, tp.torch_threads(tp.DEFAULT_THREADS):
        one = train(one_cfg, *loaders(one_cfg, run, 0, 1), resume=False,
                    device="cpu")
    return dict(jax=jout, ranks=job.results()[0], one=one, one_steps=log.steps,
                one_cfg=one_cfg, run=run,
                ddp_params=[torch.load(str(root / f"ddp.{r}.pt"))
                            for r in range(RANKS)])


def test_ddp_matches_jax(runs):
    jout = runs["jax"]
    for out in runs["ranks"]:
        for phase in ("train", "val"):
            np.testing.assert_allclose(out["losses"][phase],
                                       jout["losses"][phase], rtol=TOL,
                                       err_msg=phase)
        assert out["steps"] == int(jout["steps"]) == 4
        assert out["min_val_loss"] == pytest.approx(jout["min_val_loss"],
                                                    rel=TOL)


def test_ddp_matches_one_process(runs):
    """Losses, per-update losses, min_val_loss and every parameter at the
    end; the ranks hold the same parameters, bitwise, and the frozen towers
    are unchanged."""
    one = runs["one"]
    for out in runs["ranks"]:
        for phase in ("train", "val"):
            np.testing.assert_allclose(out["losses"][phase],
                                       one["losses"][phase], rtol=TOL)
        np.testing.assert_allclose([s["loss"] for s in out["step_log"]],
                                   [s["loss"] for s in runs["one_steps"]],
                                   rtol=TOL)
        assert out["min_val_loss"] == pytest.approx(one["min_val_loss"],
                                                    rel=TOL)
    p0, p1 = runs["ddp_params"]
    for name, p in one["trainer"].model.named_parameters():
        assert torch.equal(p0[name], p1[name]), name
        np.testing.assert_allclose(p0[name].numpy(), p.detach().numpy(),
                                   rtol=TOL, atol=1e-6, err_msg=name)


def test_mean_of_rank_means_would_fail(runs):
    """The first update at the initial weights: the token-weighted loss
    over each global microbatch is what the 2-rank run returned; the mean
    of the two ranks' own means over the same rows misses it by more than
    ``TOL`` (the ranks' token counts differ)."""
    cfg, run = runs["one_cfg"], runs["run"]
    trainer = Trainer(cfg, device="cpu")
    trainer.init_state()
    from klab_multimodalmodel_tpu_torch.checkpoint.io import (
        load_pretrained_params)

    load_pretrained_params(cfg.init_checkpoint, trainer)
    loader = loaders(cfg, run, 0, 1)[0]
    loader.set_epoch(1)
    it = iter(loader)
    micro = [next(it) for _ in range(cfg.accumulation_steps)]
    half = BATCH // RANKS
    global_means, rank_means, counts = [], [], []
    for mb in micro:
        mb = {k: v for k, v in mb.items() if k != "index"}
        global_means.append(float(trainer.eval_step(mb)))
        parts = [{k: v[r * half:(r + 1) * half] for k, v in mb.items()}
                 for r in range(RANKS)]
        rank_means.append(np.mean([float(trainer.eval_step(p))
                                   for p in parts]))
        counts.append([int(p["target_mask"].sum()) for p in parts])
    want = np.mean(global_means)
    mean_of_means = np.mean(rank_means)
    got = runs["ranks"][0]["step_log"][0]["loss"]
    print(f"token counts per microbatch and rank {counts}; global "
          f"{want:.6f}, DDP {got:.6f}, mean of rank means "
          f"{mean_of_means:.6f}")
    assert got == pytest.approx(want, rel=TOL)
    assert any(a != b for a, b in counts)
    assert abs(mean_of_means - want) > 10 * TOL * abs(want)
