"""The port's data pipeline against the JAX package's, and its host-side
pieces that need no model: the frozen-feature cache, the logger, the loss
counter, the TensorBoard writer, the config's new fields and refusals, and
the tokenizer factory.

Batches, epoch orders and dataset items are compared exactly (ids, masks,
images bitwise). Image decode: both packages decode through Pillow and
resize through their C++ runtimes, the port through its own copy of the
JAX package's, so the images are held bitwise against the JAX package's
native resize; one case holds them within 1 of Pillow's resize.
"""

import dataclasses
import json
import logging
import os
import sys

import numpy as np
import pytest
import torch

import _torch_port as tp
import klab_multimodalmodel_tpu.config as jcfg
import klab_multimodalmodel_tpu.data as jdata
import klab_multimodalmodel_tpu.native as jnative
from klab_multimodalmodel_tpu.text import ByteTokenizer as JaxByteTokenizer
from klab_multimodalmodel_tpu.text.span_corruption import (
    span_corrupt as jax_span_corrupt)
import klab_multimodalmodel_tpu_torch.config as tcfg
from klab_multimodalmodel_tpu_torch import data as tdata
from klab_multimodalmodel_tpu_torch.obs import LossCounter, Stopwatch
from klab_multimodalmodel_tpu_torch.obs.logger import get_logger
from klab_multimodalmodel_tpu_torch.obs.tb import ScalarWriter
from klab_multimodalmodel_tpu_torch.text import (ByteTokenizer,
                                                 load_tokenizer, span_corrupt)
from klab_multimodalmodel_tpu_torch.train import (FrozenFeatureCache,
                                                  swin_feature_shape)


def _loader_pair(n, batch, **kw):
    kw = dict(dict(max_source_length=40, max_target_length=24, seed=3), **kw)
    j = jdata.DataLoader(jdata.SyntheticCaptionDataset(n=n, image_size=16),
                         JaxByteTokenizer(), global_batch_size=batch, **kw)
    t = tdata.DataLoader(tdata.SyntheticCaptionDataset(n=n, image_size=16),
                         ByteTokenizer(), global_batch_size=batch, **kw)
    return j, t


def _assert_batches_equal(jb, tb):
    assert len(jb) == len(tb)
    for a, b in zip(jb, tb):
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("drop_last", [True, False])
def test_dataloader_matches_jax(drop_last):
    """Every epoch's order and batches, and a resume from batch 2."""
    j, t = _loader_pair(21, 4, drop_last=drop_last)
    assert len(j) == len(t) == (5 if drop_last else 6)
    for epoch in (1, 2):
        j.set_epoch(epoch)
        t.set_epoch(epoch)
        np.testing.assert_array_equal(t.epoch_indices(), j.epoch_indices())
        _assert_batches_equal(list(j), list(t))
        _assert_batches_equal(list(j.iter_from(2)), list(t.iter_from(2)))
    t.set_epoch(1)
    first = t.epoch_indices()
    t.set_epoch(2)
    assert not np.array_equal(first, t.epoch_indices())  # reshuffled


def test_dataloader_unshuffled_pretrain_matches_jax():
    """Validation order (no shuffle) over a span-corrupting dataset, whose
    sources change with the epoch."""
    kw = dict(max_source_length=40, max_target_length=24, seed=0,
              shuffle=False)
    j = jdata.DataLoader(jdata.SyntheticCaptionDataset(n=8, image_size=16,
                                                       pretrain=True),
                         JaxByteTokenizer(), global_batch_size=4, **kw)
    t = tdata.DataLoader(tdata.SyntheticCaptionDataset(n=8, image_size=16,
                                                       pretrain=True),
                         ByteTokenizer(), global_batch_size=4, **kw)
    for epoch in (1, 2):
        j.set_epoch(epoch)
        t.set_epoch(epoch)
        _assert_batches_equal(list(j), list(t))


def test_process_workers_match_threads():
    """Spawned decode workers give the thread pool's batches, epoch state
    included."""
    def batches(mode):
        dl = tdata.DataLoader(
            tdata.SyntheticCaptionDataset(n=8, image_size=16, pretrain=True),
            ByteTokenizer(), global_batch_size=4, max_source_length=24,
            max_target_length=16, seed=0, num_workers=2, worker_mode=mode)
        dl.set_epoch(2)
        out = list(dl)
        dl.close()
        return out

    _assert_batches_equal(batches("thread"), batches("process"))


def test_abandoned_iteration_releases_producer():
    import threading
    import time

    dl = tdata.DataLoader(tdata.SyntheticCaptionDataset(n=64, image_size=16),
                          ByteTokenizer(), global_batch_size=4,
                          max_source_length=24, max_target_length=16,
                          seed=0, num_workers=1, prefetch=1)
    dl.set_epoch(1)
    before = threading.active_count()
    it = iter(dl)
    next(it)
    it.close()  # what a halt does
    deadline = time.time() + 10.0
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before, "producer thread leaked"


@pytest.fixture(scope="module", autouse=True)
def jax_native_whole():
    """The JAX package's native library built and loaded whole before any
    test here reaches it (its datasets, resize and encoder use it):
    ``_torch_port.jax_native``."""
    tp.jax_native()


@pytest.fixture
def coco_dir(tmp_path):
    """MSCOCO layout: 3 images of seeded noise, 2 captions each, and an
    image without a caption."""
    from PIL import Image

    d = tmp_path / "mscoco2017"
    (d / "annotations").mkdir(parents=True)
    (d / "val2017").mkdir()
    rng = np.random.default_rng(0)
    images, annotations = [], []
    for i in range(4):
        name = f"{i:012d}.jpg"
        Image.fromarray(rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)
                        ).save(d / "val2017" / name)
        images.append({"id": 100 + i, "file_name": name})
        if i < 3:
            annotations.append({"id": 1000 + 2 * i, "image_id": 100 + i,
                                "caption": f"first caption {i}"})
            annotations.append({"id": 1001 + 2 * i, "image_id": 100 + i,
                                "caption": f"second caption {i}"})
    with open(d / "annotations" / "captions_val2017.json", "w") as f:
        json.dump({"images": images, "annotations": annotations}, f)
    return str(d)


@pytest.fixture
def redcaps_dir(tmp_path):
    from PIL import Image

    d = tmp_path / "redcaps"
    (d / "annotations").mkdir(parents=True)
    rng = np.random.default_rng(1)
    for sub in ("foo", "bar"):
        (d / "images" / sub).mkdir(parents=True)
        anns = []
        for i in range(3):
            img_id = f"{sub}{i}"
            Image.fromarray(rng.integers(0, 256, (40, 30, 3), dtype=np.uint8)
                            ).save(d / "images" / sub / f"{img_id}.jpg")
            anns.append({"subreddit": sub, "image_id": img_id,
                         "raw_caption": f"a photo, number {i} of {sub}! nice"})
        with open(d / "annotations" / f"{sub}.json", "w") as f:
            json.dump({"annotations": anns}, f)
    return str(d)


def _assert_items_equal(jds, tds, epochs=(0,)):
    assert len(jds) == len(tds)
    for epoch in epochs:
        jds.set_epoch(epoch)
        tds.set_epoch(epoch)
        for i in range(len(jds)):
            (ji, js, jt), (ti, ts, tt) = jds[i], tds[i]
            assert (js, jt) == (ts, tt)
            assert ti.dtype == np.uint8 and ti.shape == ji.shape
            np.testing.assert_array_equal(ti, ji)


def test_coco_dataset_matches_jax(coco_dir):
    jds = jdata.build_dataset(coco_dir, "val", image_size=32)
    tds = tdata.build_dataset(coco_dir, "val", image_size=32)
    assert isinstance(tds, tdata.CocoCaptionDataset)
    assert len(tds) == 3  # the image without a caption is left out
    assert tds[1][1:] == (tdata.COCO_PROMPT, "first caption 1")
    _assert_items_equal(jds, tds)
    tds.skip_image_load = True
    assert not tds[0][0].any()


def test_redcaps_dataset_matches_jax(redcaps_dir):
    jds = jdata.build_dataset(redcaps_dir, "train", image_size=32, seed=5)
    tds = tdata.build_dataset(redcaps_dir, "train", image_size=32, seed=5)
    assert isinstance(tds, tdata.RedCapsDataset) and not tds.source_is_static
    _assert_items_equal(jds, tds, epochs=(0, 1, 2))


def test_coco_images_within_one_of_pillow(coco_dir):
    """The native bicubic resize against Pillow's ``resize`` on the same
    decoded JPEGs: off by at most one (8-bit fixed-point coefficients in
    Pillow, doubles in the C++ code)."""
    from PIL import Image

    assert jnative.available()  # the JAX side above resizes natively
    tds = tdata.build_dataset(coco_dir, "val", image_size=32)
    for i, path in enumerate(tds.images):
        with Image.open(path) as im:
            im.draft("RGB", (32, 32))
            ref = np.asarray(im.convert("RGB").resize((32, 32)))
        got = tds[i][0]
        assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1


def test_image_bytes_loader_matches_jax(coco_dir):
    """``load_image_bytes_resized`` (encoded bytes in memory) gives the
    file loader's pixels and the JAX package's, and the resize refuses
    what it cannot take."""
    from klab_multimodalmodel_tpu.data.datasets import (
        load_image_bytes_resized as jax_bytes_loader)
    from klab_multimodalmodel_tpu_torch.data.datasets import (
        load_image_bytes_resized, load_image_resized)
    from klab_multimodalmodel_tpu_torch.native import resize_batch

    path = tdata.build_dataset(coco_dir, "val", image_size=32).images[0]
    with open(path, "rb") as f:
        data = f.read()
    got = load_image_bytes_resized(data, 24)
    np.testing.assert_array_equal(got, load_image_resized(path, 24))
    np.testing.assert_array_equal(got, jax_bytes_loader(data, 24))
    for bad in (np.zeros((4, 4, 3), np.float32), np.zeros((4, 4), np.uint8),
                np.zeros((0, 4, 3), np.uint8)):
        with pytest.raises(ValueError, match="uint8 images"):
            resize_batch([bad], 8)


@pytest.mark.parametrize("seed", range(4))
def test_span_corrupt_matches_jax(seed):
    text = "A man, with a red helmet! On a small moped? On a dirt road."
    for ratio in (0.15, 0.5):
        a = jax_span_corrupt(text, np.random.default_rng(seed), ratio)
        b = span_corrupt(text, np.random.default_rng(seed), ratio)
        assert a == b
    assert b[1].startswith("<extra_id_0>")


def test_build_dataset_dispatch():
    ds = tdata.build_dataset("synthetic-pretrain-skew", "train", 16, seed=2)
    assert isinstance(ds, tdata.SyntheticCaptionDataset)
    assert ds.pretrain and ds.skew and not ds.source_is_static
    with pytest.raises(NotImplementedError):
        tdata.build_dataset("/data/unknown", "train")


def test_get_dataloader_one_device():
    cfg = tcfg.Config(batch_size=4, data_dir="synthetic", seed=1,
                      max_source_length=40, max_target_length=24)
    train_dl = tdata.get_dataloader(cfg, "train", ByteTokenizer())
    val_dl = tdata.get_dataloader(cfg, "val", ByteTokenizer())
    assert train_dl.global_batch_size == 4 and train_dl.shuffle
    assert not val_dl.shuffle and len(val_dl) == 16
    assert train_dl.dataset.image_size == 256


# -- frozen-feature cache ----------------------------------------------------


def test_frozen_feature_cache_round_trip(tmp_path):
    """Round trip, restart, geometry change, and the old mask removed at
    once on a recreate (a crash before the next flush serves nothing)."""
    path = str(tmp_path / "c" / "train.feat")
    cache = FrozenFeatureCache(path, 8, (4, 6), dtype="float32")
    assert not cache.has(np.array([0, 3]))
    feats = np.arange(2 * 4 * 6, dtype=np.float32).reshape(2, 4, 6)
    cache.put(np.array([0, 3]), feats)
    assert cache.has(np.array([0, 3])) and not cache.has(np.array([0, 1]))
    np.testing.assert_array_equal(cache.get(np.array([3, 0])), feats[::-1])
    cache.flush()
    again = FrozenFeatureCache(path, 8, (4, 6), dtype="float32")
    assert again.has(np.array([0, 3]))
    np.testing.assert_array_equal(again.get(np.array([0, 3])), feats)
    other = FrozenFeatureCache(path, 8, (4, 8), dtype="float32")
    assert not other.has(np.array([0]))
    del other  # a crash before flush
    assert not FrozenFeatureCache(path, 8, (4, 8), dtype="float32").has(
        np.array([0, 3]))


def test_frozen_feature_cache_bf16_and_phantom_rows(tmp_path):
    """bf16 rows come back bitwise as bf16 tensors (stored as their bits);
    negative indices are never stored nor gate has(), and read row 0."""
    cache = FrozenFeatureCache(str(tmp_path / "f"), 4, (3, 5))
    rows = torch.randn(3, 3, 5, generator=torch.Generator().manual_seed(0)
                       ).to(torch.bfloat16)
    cache.put(np.array([2, -1, 0]), rows)
    assert cache.has(np.array([0, 2, -1])) and not cache.has(np.array([1]))
    got = cache.get(np.array([2, -1, 0]))
    assert got.dtype == torch.bfloat16
    assert torch.equal(got[0], rows[0]) and torch.equal(got[2], rows[2])
    assert torch.equal(got[1], rows[2])  # phantom row: row 0's contents
    cache.put(np.array([1]), np.full((1, 3, 5), 1.5, np.float32))
    assert torch.equal(cache.get(np.array([1])),
                       torch.full((1, 3, 5), 1.5, dtype=torch.bfloat16))


def test_frozen_feature_cache_flushes_only_new_rows(tmp_path):
    """A flush with nothing put since the last one leaves the files alone
    (a cached epoch writes nothing); a put makes the next flush write."""
    path = str(tmp_path / "f")
    cache = FrozenFeatureCache(path, 4, (2,), dtype="float32")
    cache.flush()
    assert not os.path.exists(path + ".mask.npy")
    cache.put(np.array([1]), np.ones((1, 2), np.float32))
    cache.flush()
    stamp = os.stat(path + ".mask.npy").st_mtime_ns
    os.utime(path + ".mask.npy", ns=(0, 0))
    cache.flush()
    assert os.stat(path + ".mask.npy").st_mtime_ns == 0
    cache.put(np.array([2]), np.ones((1, 2), np.float32))
    cache.flush()
    assert os.stat(path + ".mask.npy").st_mtime_ns > 0 and stamp > 0
    assert FrozenFeatureCache(path, 4, (2,), dtype="float32").has(
        np.array([1, 2]))


def test_frozen_feature_cache_dtype_change_invalidates(tmp_path):
    path = str(tmp_path / "c" / "train.feat")
    cache = FrozenFeatureCache(path, 4, (2, 3), dtype="float32")
    cache.put(np.array([0, 1]), np.ones((2, 2, 3), np.float32))
    cache.flush()
    assert FrozenFeatureCache(path, 4, (2, 3), dtype="float32").has(
        np.array([0, 1]))
    assert not FrozenFeatureCache(path, 4, (2, 3), dtype="bfloat16").has(
        np.array([0, 1]))


def test_frozen_feature_cache_crash_before_flush_serves_nothing(tmp_path):
    path = str(tmp_path / "c" / "train.feat")
    cache = FrozenFeatureCache(path, 8, (2, 2), dtype="float32")
    cache.put(np.arange(4), np.ones((4, 2, 2), np.float32))
    del cache  # no flush
    restarted = FrozenFeatureCache(path, 8, (2, 2), dtype="float32")
    assert not restarted.has(np.array([0]))
    restarted.put(np.array([0, 1]), np.full((2, 2, 2), 7, np.float32))
    restarted.flush()
    restarted.put(np.array([2, 3]), np.full((2, 2, 2), 9, np.float32))
    del restarted  # a crash before the second flush
    again = FrozenFeatureCache(path, 8, (2, 2), dtype="float32")
    assert again.has(np.array([0, 1])) and not again.has(np.array([2]))
    np.testing.assert_array_equal(again.get(np.array([0]))[0],
                                  np.full((2, 2), 7, np.float32))


def test_swin_feature_shape_matches_jax():
    for name in ("microsoft/swinv2-base-patch4-window8-256",
                 "microsoft/swinv2-large-patch4-window12-192-22k"):
        assert swin_feature_shape(tcfg.Config(image_model_name=name)) == (
            jcfg.Config(image_model_name=name).swin.num_patches_out,
            jcfg.Config(image_model_name=name).swin.num_features)
    assert swin_feature_shape(tcfg.Config()) == (64, 1024)


# -- observability -------------------------------------------------------------


def test_logger_repoints_file_handler_across_result_dirs(tmp_path):
    d1, d2 = str(tmp_path / "run1"), str(tmp_path / "run2")
    get_logger(d1).info("first run")
    get_logger(d2).info("second run")
    get_logger(d2).info("still second run")  # same dir: file kept
    with open(os.path.join(d1, "train.log")) as f:
        assert "first run" in f.read()
    with open(os.path.join(d2, "train.log")) as f:
        content = f.read()
    assert "second run" in content and "still second run" in content
    assert "first run" not in content
    files = [h for h in get_logger(d2).handlers
             if isinstance(h, logging.FileHandler)]
    assert len(files) == 1


def test_loss_counter_keeps_device_values_until_the_epoch_closes():
    """Means as total / loader length in float64 over the host floats of
    the fp32 losses (JAX's rule); state_dict carries the partials."""
    c = LossCounter(3, 2)
    vals = [torch.tensor(1.1), torch.tensor(2.25), torch.tensor(0.3)]
    for v in vals[:2]:
        c.add_loss("train", v)
    c.add_loss("val", torch.tensor(4.0))
    state = json.loads(json.dumps(c.state_dict()))
    assert state["pending"]["train"] == [float(v) for v in vals[:2]]
    resumed = LossCounter(3, 2)
    resumed.load_state_dict(state)
    for counter in (c, resumed):
        counter.add_loss("train", vals[2])
        tr, va = counter.count_and_get_loss()
        assert tr == float(np.sum([float(v) for v in vals])) / 3
        assert va == 2.0
    assert c.losses == resumed.losses


def test_plot_loss_with_and_without_matplotlib(tmp_path, monkeypatch):
    c = LossCounter(1, 1)
    c.losses = {"train": [3.0, 2.0], "val": [3.5, 2.5]}
    assert os.path.exists(c.plot_loss(str(tmp_path)))
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError):
        c.plot_loss(str(tmp_path / "none"))


def test_scalar_writer(tmp_path):
    off = ScalarWriter(None)
    assert not off.enabled
    off.scalar("x", 1.0, 1)
    off.close()
    on = ScalarWriter(str(tmp_path / "tb"))
    on.scalar("loss/train", 2.5, 1)
    on.close()
    assert any(n.startswith("events.") for n in os.listdir(tmp_path / "tb"))


def test_profiler_trace(tmp_path):
    from klab_multimodalmodel_tpu_torch.obs import profiler

    with profiler.trace(str(tmp_path / "off"), enabled=False):
        torch.ones(4).sum()
    assert not (tmp_path / "off").exists()
    with profiler.trace(str(tmp_path / "on")):
        with profiler.annotate("step"):
            torch.ones(4).sum()
    assert (tmp_path / "on" / "profile" / "trace.json").exists()


def test_stopwatch_counts():
    sw = Stopwatch()
    sw.tick(32)
    sw.tick(32)
    assert sw.rate() > 0


# -- config and tokenizer ------------------------------------------------------


@pytest.mark.parametrize("field,value,error,match", [
    ("mesh_shape", (1, 1, 1, 1, 1, 2), ValueError, "requires --moe_experts"),
    ("profile_server_port", 9999, NotImplementedError, "profiler server"),
    ("accumulation_tail", "wrap", ValueError, "accumulation_tail"),
    ("decode_workers", "fiber", ValueError, "decode_workers"),
])
def test_config_refusals(field, value, error, match):
    with pytest.raises(error, match=match):
        tcfg.Config(**{field: value})


@pytest.mark.parametrize("pretrain", [False, True])
def test_config_accepts_native_tokenizer(tmp_path, pretrain):
    """``native_tokenizer`` with a ``tokenizer_path`` (a spiece.model):
    ``get_dataloader``'s batches equal the JAX loader's with the JAX C++
    encoder, and the port's loader built without the flag. Without a path
    it raises as the JAX one does."""
    from klab_multimodalmodel_tpu.text.tokenizer import (
        UnigramTokenizer as JaxUnigramTokenizer)
    from test_torch_text_unigram import write_spm

    path = write_spm(tmp_path / "spiece.model")
    cfg = tcfg.Config(native_tokenizer=True, tokenizer_path=path,
                      data_dir="synthetic-pretrain" if pretrain
                      else "synthetic", batch_size=4, max_source_length=24,
                      max_target_length=16, num_workers=2,
                      image_model_name=tp.SWIN_NAME)
    tok = load_tokenizer(path)
    loader = tdata.get_dataloader(cfg, "train", tok)
    kw = dict(global_batch_size=4, max_source_length=24,
              max_target_length=16, seed=0)
    j = jdata.DataLoader(jdata.SyntheticCaptionDataset(
        n=64, image_size=32, pretrain=pretrain), JaxUnigramTokenizer(path),
        native_encoder=jnative.NativeUnigramEncoder(path), **kw)
    plain = tdata.DataLoader(tdata.SyntheticCaptionDataset(
        n=64, image_size=32, pretrain=pretrain), tok, **kw)
    for dl in (loader, j, plain):
        dl.set_epoch(1)
    native_batches = list(loader)
    _assert_batches_equal(list(j), native_batches)
    _assert_batches_equal(list(plain), native_batches)
    with pytest.raises(ValueError, match="requires --tokenizer_path"):
        tdata.get_dataloader(dataclasses.replace(cfg, tokenizer_path=""),
                             "train", tok)


def test_config_accepts_caption_evaluation():
    """The loop's caption evaluation is ported: the field and its image
    limit carry the JAX package's defaults and take a value."""
    cfg = tcfg.Config(eval_captions_every=2, eval_captions_limit=16)
    assert (cfg.eval_captions_every, cfg.eval_captions_limit) == (2, 16)
    d, jd = tcfg.Config(), jcfg.Config()
    assert (d.eval_captions_every, d.eval_captions_limit) == (
        jd.eval_captions_every, jd.eval_captions_limit)


def test_config_rejects_jax_invalid_combinations():
    for kw in (dict(bucket_lengths=True, reference_pad_quirks=True),
               dict(cache_frozen_features=True, image_model_train=True)):
        for cls in (jcfg.Config, tcfg.Config):
            with pytest.raises(ValueError):
                cls(**kw)


def test_config_json_round_trip_and_jax_file(tmp_path):
    cfg = tcfg.Config(num_epochs=3, save_interval=2, batch_size=8,
                      result_dir=str(tmp_path), cache_frozen_features=True)
    path = cfg.save()
    assert path == os.path.join(str(tmp_path), "config.json")
    with open(path) as f:
        assert tcfg.Config.from_json(f.read()) == cfg
    # A JAX run's config.json: its mesh is read (the data axis is the
    # port's), its other multi-host fields are ignored.
    jax_cfg = jcfg.Config(num_epochs=3, batch_size=8, halt_after_steps=7,
                          mesh_shape=(2, 1, 1), dcn_mesh_shape=(2, 1, 1))
    port = tcfg.Config.from_json(jax_cfg.to_json())
    assert (port.num_epochs, port.batch_size, port.halt_after_steps) == (
        3, 8, 7)
    assert port.mesh_shape == jax_cfg.mesh_shape == (2, 1, 1, 1, 1, 1)
    assert port.dcn_mesh_shape == jax_cfg.dcn_mesh_shape
    assert port.mesh_axis_names == jax_cfg.mesh_axis_names
    names = {f.name for f in dataclasses.fields(tcfg.Config)}
    assert "dropout_rng_impl" not in names


def test_load_tokenizer(tmp_path):
    """'' gives the byte tokenizer, a spiece.model the unigram tokenizer,
    each with the JAX package's ids."""
    from klab_multimodalmodel_tpu.text import load_tokenizer as jax_load
    from klab_multimodalmodel_tpu_torch.text import UnigramTokenizer
    from test_torch_text_unigram import write_spm

    prompt = ["What does th image describe ?"]
    tok = load_tokenizer("")
    assert isinstance(tok, ByteTokenizer)
    ids = tok(prompt, max_length=40).input_ids
    np.testing.assert_array_equal(
        ids, JaxByteTokenizer()(prompt, max_length=40).input_ids)
    path = write_spm(tmp_path / "spiece.model")
    tok = load_tokenizer(path)
    assert isinstance(tok, UnigramTokenizer)
    np.testing.assert_array_equal(tok(prompt, max_length=40).input_ids,
                                  jax_load(path)(prompt,
                                                 max_length=40).input_ids)
    with pytest.raises(FileNotFoundError):
        load_tokenizer(str(tmp_path / "missing.model"))
