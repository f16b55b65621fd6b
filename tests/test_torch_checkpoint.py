"""The port's ``CheckpointManager``: a save is the state at the moment of
the call, a restore resumes the optimizer exactly (``AdamBf16Mu``'s bf16
moment included), ``latest()`` ranks by the recorded optimizer steps, and a
save that fails midway leaves nothing ``latest()`` would pick."""

import json
import os

import numpy as np
import pytest
import torch

import _torch_port as tp
import klab_multimodalmodel_tpu_torch.checkpoint.io as ckio
from klab_multimodalmodel_tpu_torch.checkpoint.io import CheckpointManager
from klab_multimodalmodel_tpu_torch.train import Trainer


def trainer(**kw):
    cfg = tp.configs(compute_dtype="float32", max_target_length=8, **kw)[1]
    t = Trainer(cfg, device="cpu")
    t.init_state()
    return t


def batch(cfg, seed):
    g = np.random.default_rng(seed)
    S = cfg.swin.image_size
    return dict(images=g.integers(0, 256, (2, S, S, 3), dtype=np.uint8),
                source_ids=g.integers(2, 512, (2, 32)).astype(np.int32),
                source_mask=np.ones((2, 32), np.int32),
                target_ids=g.integers(2, 512, (2, 8)).astype(np.int32),
                target_mask=np.ones((2, 8), np.int32))


def state(t):
    return {k: v.clone() for k, v in t.model.state_dict().items()}


def assert_equal_states(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("overrides", [
    {}, {"adam_mu_dtype": "bfloat16", "frozen_param_dtype": "bfloat16"},
    {"optimizer": "adafactor", "lr_scheduler": "cosine"}],
    ids=["adam", "bf16_mu_and_towers", "adafactor_cosine"])
def test_save_is_a_snapshot_and_restore_resumes_exactly(tmp_path, overrides):
    t = trainer(**overrides)
    t.train_step(batch(t.config, 0))
    snapshot = state(t)
    ck = CheckpointManager(str(tmp_path))
    ck.save("step_1", t, {"epoch": 0})
    t.train_step(batch(t.config, 1))  # the write may still be in flight
    after_two = state(t)
    ck.wait()

    fresh = trainer(**overrides)
    ck.restore("step_1", fresh)
    assert fresh.step == 1
    assert_equal_states(state(fresh), snapshot)
    for live in fresh.optimizer.state.values():
        for key, value in live.items():
            if key == "mu":
                assert value.dtype == torch.bfloat16
    fresh.train_step(batch(t.config, 1))
    assert_equal_states(state(fresh), after_two)
    assert (fresh.scheduler.get_last_lr() == t.scheduler.get_last_lr())
    assert ck.load_metadata("step_1") == {"steps": 1, "epoch": 0}
    assert ck.saves[0]["bytes"] > 0 and ck.saves[0]["write_s"] >= 0


def _fake_checkpoint(ck, name, sidecar_steps=None, inner_steps=None):
    os.makedirs(ck.path(name))
    if inner_steps is not None:
        with open(os.path.join(ck.path(name), "meta.json"), "w") as f:
            json.dump({"steps": inner_steps}, f)
    if sidecar_steps is not None:
        with open(os.path.join(ck.base, f"{name}.meta.json"), "w") as f:
            json.dump({"steps": sidecar_steps}, f)


def test_latest_ranks_by_recorded_steps(tmp_path):
    """An epoch_N whose sidecar is missing ranks by the step count inside
    it, not by its N against step counts; a directory that records no step
    count is no checkpoint; best is never a resume point."""
    ck = CheckpointManager(str(tmp_path))
    assert ck.latest() is None
    _fake_checkpoint(ck, "step_20", sidecar_steps=20, inner_steps=20)
    _fake_checkpoint(ck, "epoch_3", inner_steps=30)  # no sidecar
    _fake_checkpoint(ck, "best", sidecar_steps=99, inner_steps=99)
    _fake_checkpoint(ck, "step_90")  # records nothing
    assert ck.latest() == "epoch_3"
    _fake_checkpoint(ck, "step_40", sidecar_steps=40, inner_steps=40)
    assert ck.latest() == "step_40"
    assert ck.load_metadata("epoch_3") == {"steps": 30}


def test_interrupted_save_leaves_no_checkpoint(tmp_path, monkeypatch):
    """A write that dies midway leaves only its temporary directory, which
    latest() does not match; the error surfaces at wait(). An overwrite of
    best that dies keeps the previous best whole."""
    t = trainer()
    ck = CheckpointManager(str(tmp_path))
    ck.save("step_1", t, {"epoch": 0})
    ck.save("best", t, {"epoch": 0})
    ck.wait()
    real = torch.save

    def dying(obj, path, *a, **kw):
        if os.path.basename(path) == ckio.TRAIN_STATE_FILE:
            with open(path, "wb") as f:
                f.write(b"partial")
            raise OSError("disk full")
        return real(obj, path, *a, **kw)

    monkeypatch.setattr(torch, "save", dying)
    t.step = 2
    ck.save("step_2", t, {"epoch": 1})
    with pytest.raises(RuntimeError, match="checkpoint write failed"):
        ck.wait()
    assert not ck.exists("step_2")
    assert ck.latest() == "step_1"
    ck.save("best", t, {"epoch": 1})
    with pytest.raises(RuntimeError):
        ck.wait()
    monkeypatch.setattr(torch, "save", real)
    assert ck.load_metadata("best") == {"steps": 0, "epoch": 0}
    fresh = trainer()
    ck.restore("best", fresh)
    assert fresh.step == 0


def test_overwrite_keeps_sidecar_and_contents_together(tmp_path):
    t = trainer()
    ck = CheckpointManager(str(tmp_path))
    ck.save("best", t, {"epoch": 1})
    t.train_step(batch(t.config, 0))
    ck.save("best", t, {"epoch": 2})
    ck.wait()
    assert ck.load_metadata("best") == {"steps": 1, "epoch": 2}
    fresh = trainer()
    ck.restore("best", fresh)
    assert fresh.step == 1
    assert_equal_states(state(fresh), state(t))
    assert sorted(os.listdir(ck.base)) == ["best", "best.meta.json"]
