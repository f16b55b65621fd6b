"""The port's training loop ``train()`` against the JAX package's, and the
pretrained initialization it starts from.

Both loops start from the JAX ``Trainer.init_state`` parameters: the JAX
run draws them itself from ``config.seed``; the port's run loads them,
converted by ``convert_jax_params``, from a pretrained checkpoint through
``init_checkpoint`` (``load_pretrained_params``). Both read the same
synthetic batches (their own ``DataLoader``s, the same seed), at the tiny
geometry of ``tests/_torch_port.py``, fp32 compute, dropout 0 (a JAX key
stream and a torch generator cannot match) and the kernel flags off (the
kernels' parity has its own tests). The per-epoch train and val losses agree
within 1e-4 relative: fp32 summation order through two epochs of Adam.

Two configurations: plain (2 epochs, no accumulation, no cache), and
options (accumulation 2 over a loader of 3 batches, so the second update is
the ragged 'pad' tail; ``bucket_lengths``; the frozen-feature cache).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax

import _torch_port as tp
from klab_multimodalmodel_tpu.data import DataLoader as JaxDataLoader
from klab_multimodalmodel_tpu.data import (
    SyntheticCaptionDataset as JaxSynthetic)
from klab_multimodalmodel_tpu.text import ByteTokenizer as JaxByteTokenizer
from klab_multimodalmodel_tpu.train import Trainer as JaxTrainer
from klab_multimodalmodel_tpu.train import train as jax_train
from klab_multimodalmodel_tpu.utils import make_mesh
from klab_multimodalmodel_tpu_torch.checkpoint.from_jax import (
    convert_jax_params)
from klab_multimodalmodel_tpu_torch.checkpoint.io import (
    load_pretrained_params, save_pretrained)
from klab_multimodalmodel_tpu_torch.data import DataLoader, SyntheticCaptionDataset
from klab_multimodalmodel_tpu_torch.text import ByteTokenizer
from klab_multimodalmodel_tpu_torch.train import Trainer, train

TOL = 1e-4
BATCH = 8  # the JAX run's global batch over its 8 virtual CPU devices


def _configs(tmp_path, tag, **kw):
    kw = dict(dict(compute_dtype="float32", batch_size=1, num_epochs=2,
                   max_target_length=24, data_dir="synthetic"), **kw)
    jc, tc = tp.configs(kernels=False, **kw)
    jc = dataclasses.replace(jc, scan_unroll=1,  # one loop: a fast compile
                             result_dir=str(tmp_path / tag / "jax"))
    tc = dataclasses.replace(tc, result_dir=str(tmp_path / tag / "torch"))
    return jc, tc


def _loaders(cfg, synthetic, dataloader, tokenizer, n_train, n_val):
    def make(n):
        return dataloader(synthetic(n=n, image_size=cfg.swin.image_size),
                          tokenizer(), global_batch_size=BATCH,
                          max_source_length=cfg.max_source_length,
                          max_target_length=cfg.max_target_length, seed=0)
    return make(n_train), make(n_val)


@pytest.fixture(scope="module")
def pretrained(tmp_path_factory):
    """The JAX run's initial parameters as a port pretrained checkpoint."""
    jc, tc = _configs(tmp_path_factory.mktemp("init"), "init")
    mesh = make_mesh(jc.mesh_shape, jc.mesh_axis_names)
    state = JaxTrainer(jc, mesh, num_epochs=2).init_state(
        jax.random.PRNGKey(jc.seed), BATCH)
    params = jax.tree.map(np.asarray, jax.device_get(state.params))
    out = tmp_path_factory.mktemp("pretrained")
    save_pretrained(str(out), convert_jax_params(params, tc))
    return str(out)


def _run_both(tmp_path, pretrained, tag, n_train, n_val, **kw):
    jc, tc = _configs(tmp_path, tag, **kw)
    tc = dataclasses.replace(tc, init_checkpoint=pretrained)
    jout = jax_train(jc, *_loaders(jc, JaxSynthetic, JaxDataLoader,
                                   JaxByteTokenizer, n_train, n_val),
                     resume=False)
    tout = train(tc, *_loaders(tc, SyntheticCaptionDataset, DataLoader,
                               ByteTokenizer, n_train, n_val),
                 resume=False, device="cpu")
    return jout, tout, tc


def _assert_losses_match(jout, tout):
    for phase in ("train", "val"):
        np.testing.assert_allclose(tout["losses"][phase],
                                   jout["losses"][phase], rtol=TOL,
                                   err_msg=phase)
    assert int(tout["steps"]) == int(jout["steps"])


def test_train_matches_jax_plain(tmp_path, pretrained):
    jout, tout, tc = _run_both(tmp_path, pretrained, "plain", 16, 8)
    _assert_losses_match(jout, tout)
    assert int(tout["steps"]) == 4
    assert tout["min_val_loss"] == pytest.approx(jout["min_val_loss"],
                                                 rel=TOL)
    assert os.path.isdir(os.path.join(tc.result_dir, "checkpoints", "best"))


def test_train_matches_jax_with_accumulation_buckets_and_cache(
        tmp_path, pretrained):
    jout, tout, tc = _run_both(
        tmp_path, pretrained, "options", 24, 8, accumulation_steps=2,
        bucket_lengths=True, cache_frozen_features=True,
        max_source_length=64, max_target_length=80)
    _assert_losses_match(jout, tout)
    assert int(tout["steps"]) == 4  # two updates an epoch: one is the tail
    cache = os.path.join(tc.result_dir, "feature_cache")
    for tag in ("train", "val"):
        for kind in ("img", "lang"):
            assert os.path.exists(os.path.join(cache, f"{tag}.{kind}.feat"))


def test_load_pretrained_params(tmp_path, pretrained):
    """The submodules a pretrained checkpoint holds replace the fresh ones,
    exactly; the others keep their fresh weights; a submodule the model
    lacks raises."""
    _, tc = _configs(tmp_path, "load")
    t = Trainer(tc, device="cpu")
    t.init_state()
    fresh = {k: v.clone() for k, v in t.model.state_dict().items()}
    saved = torch.load(os.path.join(pretrained, "checkpoints", "pretrained",
                                    "model.pt"), weights_only=True)
    part = {k: v + 1.0 for k, v in saved.items()
            if k.startswith("transformer.")}
    out = tmp_path / "part"
    save_pretrained(str(out), part)
    assert load_pretrained_params(str(out), t) == ["transformer"]
    for k, v in t.model.state_dict().items():
        want = part[k] if k.startswith("transformer.") else fresh[k]
        assert torch.equal(v, want), k
    save_pretrained(str(tmp_path / "bad"), {"not_a_tower.w": torch.zeros(2)})
    with pytest.raises(ValueError, match="not_a_tower"):
        load_pretrained_params(str(tmp_path / "bad"), t)
