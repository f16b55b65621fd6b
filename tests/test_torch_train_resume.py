"""The port's training loop on its own (the JAX package's
``tests/test_train.py`` cases): exact mid-epoch resume after a halt or a
SIGTERM, the frozen-feature cache against the uncached run, length buckets,
the accumulation tail's rules, and what a run writes (``metrics.jsonl``,
TensorBoard scalars, the profile, ``loss.png`` or its absence).

Tiny geometry of ``tests/_torch_port.py``, fp32 compute, the kernel flags on
(the wrappers take their plain versions on CPU tensors), on the CPU.
"""

import dataclasses
import glob
import json
import os
import signal
import sys

import numpy as np
import pytest
import torch

import _torch_port as tp
import klab_multimodalmodel_tpu_torch.config as tcfg
import klab_multimodalmodel_tpu_torch.data.datasets as dsmod
from klab_multimodalmodel_tpu_torch.data import (DataLoader,
                                                 SyntheticCaptionDataset)
from klab_multimodalmodel_tpu_torch.obs import profiler
from klab_multimodalmodel_tpu_torch.text import ByteTokenizer
from klab_multimodalmodel_tpu_torch.train import Trainer, train

DROP_T5 = "t5-torchport-tiny-dropout"
tcfg.register_t5_size(DROP_T5, tcfg.T5Size(**dict(tp.TINY_T5,
                                                  dropout_rate=0.1)))


def config(tmp_path, tag, **kw):
    kw = dict(dict(compute_dtype="float32", batch_size=8, num_epochs=2,
                   max_target_length=24, data_dir="synthetic"), **kw)
    return dataclasses.replace(tp.configs(**kw)[1],
                               result_dir=str(tmp_path / tag))


def loaders(cfg, n_train=16, n_val=8, **ds_kw):
    def make(n):
        ds = SyntheticCaptionDataset(n=n, image_size=cfg.swin.image_size,
                                     **ds_kw)
        return DataLoader(ds, ByteTokenizer(), global_batch_size=8,
                          max_source_length=cfg.max_source_length,
                          max_target_length=cfg.max_target_length, seed=0)
    return make(n_train), make(n_val)


def run(cfg, resume=False, **loader_kw):
    return train(cfg, *loaders(cfg, **loader_kw), resume=resume,
                 device="cpu")


def assert_same_run(a, b):
    sa = a["trainer"].model.state_dict()
    sb = b["trainer"].model.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    assert a["losses"] == b["losses"]
    assert a["min_val_loss"] == b["min_val_loss"]
    assert int(a["steps"]) == int(b["steps"]) == 4


def test_midepoch_resume_is_exact(tmp_path):
    """Halt after update 3 (epoch 2, cursor 1 of 2), rerun the same command:
    the resumed run equals the uninterrupted one bitwise, with dropout on,
    so the generator's state, the cursor and the loss partials all count."""
    def cfg(tag):
        return config(tmp_path, tag, language_model_name=DROP_T5,
                      transformer_model_name=DROP_T5, halt_after_steps=3)

    a = run(dataclasses.replace(cfg("a"), halt_after_steps=0), resume=True)
    assert not a["halted"]
    b1 = run(cfg("b"), resume=True)
    assert b1["halted"] and int(b1["steps"]) == 3
    assert os.path.isdir(os.path.join(cfg("b").result_dir, "checkpoints",
                                      "step_3"))
    b2 = run(cfg("b"), resume=True)  # the threshold is spent: runs to the end
    assert not b2["halted"]
    assert_same_run(a, b2)
    assert not os.path.isdir(os.path.join(cfg("a").result_dir, "tb"))


def test_sigterm_save_and_resume(tmp_path, monkeypatch):
    """SIGTERM finishes the update in flight, saves step_N and stops; the
    restarted run equals the uninterrupted one bitwise."""
    orig = profiler.StepWindowTrace.tick
    calls = {"n": 0}

    def tick(self):
        calls["n"] += 1
        if calls["n"] == 3:
            # Delivered before update 3 completes: the halt follows it.
            os.kill(os.getpid(), signal.SIGTERM)
        return orig(self)

    def cfg(tag):
        return config(tmp_path, tag, language_model_name=DROP_T5,
                      transformer_model_name=DROP_T5)

    a = run(cfg("a"), resume=True)
    monkeypatch.setattr(profiler.StepWindowTrace, "tick", tick)
    b1 = run(cfg("b"), resume=True)
    assert b1["halted"] and int(b1["steps"]) == 3
    monkeypatch.setattr(profiler.StepWindowTrace, "tick", orig)
    b2 = run(cfg("b"), resume=True)
    assert not b2["halted"]
    assert_same_run(a, b2)
    assert signal.getsignal(signal.SIGTERM) is not None


@pytest.mark.parametrize("pretrain", [False, True],
                         ids=["static_prompt", "span_corruption"])
def test_cached_features_match_uncached(tmp_path, monkeypatch, pretrain):
    """Epoch 1 fills the caches, epochs 2-3 train from them: the losses of
    the uncached run within 2e-6. A static prompt caches the text tower's
    output too; span corruption (a source that changes per epoch) does
    not."""
    steps = []
    orig = Trainer.train_step

    def recording(self, batch, generator=None):
        steps.append(sorted(k for k in batch if k.endswith("features")))
        return orig(self, batch, generator)

    monkeypatch.setattr(Trainer, "train_step", recording)
    losses = {}
    for cached in (False, True):
        steps.clear()
        cfg = config(tmp_path, f"{pretrain}-{cached}", num_epochs=3,
                     cache_frozen_features=cached)
        out = run(cfg, pretrain=pretrain)
        losses[cached] = out["losses"]
    # Cached run: epoch 1 takes the full steps (train_step_with_features),
    # epochs 2-3 the cached ones.
    feats = ["image_features"] + ([] if pretrain else ["language_features"])
    assert steps == [feats] * 4
    cache_dir = os.path.join(cfg.result_dir, "feature_cache")
    assert os.path.exists(os.path.join(cache_dir, "train.img.feat"))
    assert os.path.exists(os.path.join(cache_dir, "train.img.feat.mask.npy"))
    assert os.path.exists(os.path.join(cache_dir, "train.lang.feat")) == (
        not pretrain)
    for phase in ("train", "val"):
        np.testing.assert_allclose(losses[True][phase], losses[False][phase],
                                   rtol=2e-6, err_msg=phase)


def test_bucket_lengths_match_full_padding(tmp_path):
    """Power-of-two buckets trim pad columns (source 48 -> 32, target 80 ->
    64) without changing the losses, with and without the cache (its
    zero-padded language rows are mask-equivalent)."""
    losses = {}
    for tag, kw in (("full", {}), ("bucketed", {"bucket_lengths": True}),
                    ("bucketed_cached", {"bucket_lengths": True,
                                         "cache_frozen_features": True})):
        cfg = config(tmp_path, tag, max_source_length=48,
                     max_target_length=80, **kw)
        losses[tag] = run(cfg)["losses"]
    for tag in ("bucketed", "bucketed_cached"):
        for phase in ("train", "val"):
            np.testing.assert_allclose(losses[tag][phase],
                                       losses["full"][phase], rtol=1e-6,
                                       err_msg=f"{tag} {phase}")


def _coco_dir(tmp_path):
    from PIL import Image

    d = tmp_path / "mscoco2017"
    (d / "annotations").mkdir(parents=True)
    rng = np.random.default_rng(0)
    for phase in ("train", "val"):
        (d / f"{phase}2017").mkdir()
        images, annotations = [], []
        for i in range(8):
            name = f"{i:012d}.jpg"
            arr = rng.integers(0, 255, (48, 64, 3), dtype=np.uint8)
            Image.fromarray(arr).save(d / f"{phase}2017" / name)
            images.append({"id": i, "file_name": name})
            annotations.append({"id": 10 + i, "image_id": i,
                                "caption": f"caption number {i}"})
        with open(d / "annotations" / f"captions_{phase}2017.json",
                  "w") as f:
            json.dump({"images": images, "annotations": annotations}, f)
    return str(d)


def test_skip_image_decode_when_fully_cached(tmp_path, monkeypatch):
    """Through get_dataloader on a COCO layout: a fully cached epoch decodes
    no image, and the losses equal the uncached run's."""
    data_dir = _coco_dir(tmp_path)
    decoded: list = []
    real = dsmod.load_image_resized

    def counting(path, size=256):
        decoded.append(path)
        return real(path, size)

    monkeypatch.setattr(dsmod, "load_image_resized", counting)
    outs = {}
    for cached in (True, False):
        decoded.clear()
        cfg = config(tmp_path, f"coco-{cached}", data_dir=data_dir,
                     num_epochs=3, cache_frozen_features=cached)
        outs[cached] = train(cfg, resume=False, device="cpu")["losses"]
        # 8 train + 8 val images in epoch 1; none later when cached.
        assert len(decoded) == (16 if cached else 48)
    for phase in ("train", "val"):
        np.testing.assert_allclose(outs[True][phase], outs[False][phase],
                                   rtol=1e-6)


@pytest.mark.parametrize("tail,kw,match", [
    ("error", {}, "accumulation_tail"),
    ("pad", {"reference_pad_quirks": True}, "reference_pad_quirks"),
    ("drop", {"accumulation_steps": 8}, "ZERO optimizer updates"),
], ids=["error", "pad_with_pad_quirks", "drop_everything"])
def test_accumulation_tail_rejections(tmp_path, tail, kw, match):
    kw = dict(dict(accumulation_steps=2), **kw)
    cfg = config(tmp_path, tail, accumulation_tail=tail, **kw)
    with pytest.raises(ValueError, match=match):
        run(cfg, n_train=24)  # 3 microbatches


def test_accumulation_tail_modes(tmp_path):
    """3 microbatches, accumulation 2: 'pad' runs the ragged update (2
    steps an epoch), 'drop' skips it (1)."""
    for tail, steps in (("pad", 2), ("drop", 1)):
        cfg = config(tmp_path, tail, accumulation_steps=2, num_epochs=1,
                     accumulation_tail=tail)
        out = run(cfg, n_train=24)
        assert int(out["steps"]) == steps
        assert all(np.isfinite(out["losses"]["train"]))


def test_metrics_tensorboard_and_profile(tmp_path):
    """metrics.jsonl gets one line per epoch; TensorBoard event files and
    the profile of the first step are written; loss.png is plotted."""
    cfg = config(tmp_path, "obs", tensorboard=True, profile_steps=1)
    out = run(cfg)
    rows = [json.loads(line) for line in
            open(os.path.join(cfg.result_dir, "metrics.jsonl"))]
    assert [r["epoch"] for r in rows] == [1, 2]
    assert rows[-1]["train_loss"] == out["losses"]["train"][-1]
    for key in ("val_loss", "img_per_sec", "lr", "epoch_seconds", "steps"):
        assert key in rows[0]
    assert glob.glob(os.path.join(cfg.result_dir, "tb", "events.*"))
    assert os.path.exists(os.path.join(cfg.result_dir, "profile",
                                       "trace.json"))
    assert os.path.exists(os.path.join(cfg.result_dir, "loss.png"))
    assert os.path.exists(os.path.join(cfg.result_dir, "config.json"))
    with open(os.path.join(cfg.result_dir, "config.json")) as f:
        assert tcfg.Config.from_json(f.read()) == cfg


def test_train_without_matplotlib(tmp_path, monkeypatch):
    """Where matplotlib is missing, train() says in one log line that
    loss.png was not written and finishes; metrics.jsonl has the curve."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    cfg = config(tmp_path, "nomatplotlib", num_epochs=1)
    out = run(cfg)
    assert not out["halted"]
    assert not os.path.exists(os.path.join(cfg.result_dir, "loss.png"))
    with open(os.path.join(cfg.result_dir, "train.log")) as f:
        assert "loss.png not written" in f.read()
    assert os.path.exists(os.path.join(cfg.result_dir, "metrics.jsonl"))
