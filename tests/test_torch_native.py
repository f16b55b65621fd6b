"""The port's C++ host runtime (``klab_multimodalmodel_tpu_torch/native``)
against the JAX package's: the bicubic and bilinear resize bitwise, the
unigram core's batch encode exactly, and the copied ``spm_proto`` and
``charsmap`` modules value for value. A build that fails raises; nothing
falls back to Pillow."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

import _torch_port as tp
import klab_multimodalmodel_tpu.native as jnative
from klab_multimodalmodel_tpu.text import charsmap as jcharsmap
from klab_multimodalmodel_tpu.text import spm_proto as jspm
from klab_multimodalmodel_tpu.text.tokenizer import (
    UnigramTokenizer as JaxUnigramTokenizer, train_unigram_tokenizer)
from klab_multimodalmodel_tpu_torch import native
from klab_multimodalmodel_tpu_torch.text import charsmap as tcharsmap
from klab_multimodalmodel_tpu_torch.text import spm_proto as tspm
from klab_multimodalmodel_tpu_torch.text import load_tokenizer
from test_torch_text_unigram import CHARSMAP, ROOT, write_spm

SIZES = [(123, 217), (256, 256), (480, 640), (640, 427), (31, 500),
         (7, 9)]


@pytest.fixture(scope="module", autouse=True)
def jax_native_whole():
    """The JAX package's native library built and loaded whole before any
    test here reaches it (its datasets, resize and encoder use it):
    ``_torch_port.jax_native``."""
    tp.jax_native()


@pytest.mark.parametrize("filt", ["BICUBIC", "BILINEAR"])
@pytest.mark.parametrize("size", [32, 256])
def test_resize_bitwise_jax(filt, size):
    """Mixed sizes in one batch, up- and downscaled."""
    rng = np.random.default_rng(size)
    images = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
              for h, w in SIZES]
    want = jnative.resize_batch(images, size, filter=getattr(jnative, filt))
    got = native.resize_batch(images, size, filter=getattr(native, filt),
                              n_threads=3)
    assert got.shape == (len(SIZES), size, size, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("filt,shape,size", [
    ("BICUBIC", (123, 217), 64), ("BILINEAR", (80, 50), 32)])
def test_resize_within_one_of_pillow(filt, shape, size):
    """Pillow rounds through 8-bit fixed-point coefficients where the C++
    code keeps doubles: off by at most one."""
    from PIL import Image

    img = np.random.default_rng(1).integers(0, 256, shape + (3,),
                                            dtype=np.uint8)
    ref = np.asarray(Image.fromarray(img).resize(
        (size, size), resample=getattr(Image.Resampling, filt)))
    out = native.resize_batch([img], size, filter=getattr(native, filt))[0]
    assert np.abs(out.astype(int) - ref.astype(int)).max() <= 1


def _encoders(path):
    return native.NativeUnigramEncoder(path), jnative.NativeUnigramEncoder(
        path)


CORPUS = ["a cat", "the dog .", "What does th image describe ?",
          "Ａ cat", "x①y", "a　b", "ﬁle", "¼ cup", "héllo", "a  b", "  a",
          "a ", "", " ", "a\tb", "ZZZ", "aZZb", "<extra_id_0> cat",
          "a <extra_id_0> b <extra_id_1>", "dog  <extra_id_1>  cat",
          "th e " * 12]


@pytest.mark.parametrize("max_len", [1, 6, 40])
def test_encode_batch_matches_jax_on_spiece(tmp_path, max_len):
    """The spiece.model chain (charsmap, strip, collapse, sentinels):
    ids and masks equal, truncation and padding included."""
    path = write_spm(tmp_path / "spiece.model",
                     jcharsmap.build_charsmap(CHARSMAP))
    port, jax = _encoders(path)
    for pad, eos in ((0, 1), (7, 9)):
        got = port.encode_batch(CORPUS, max_len, pad, eos)
        want = jax.encode_batch(CORPUS, max_len, pad, eos)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_encode_batch_matches_jax_on_trained_json(tmp_path):
    """A trained tokenizer.json on texts with single spaces, where the JAX
    core's fixed spiece.model chain and the file's own chain agree."""
    path = str(tmp_path / "tok.json")
    train_unigram_tokenizer(["a man rides a moped down the road",
                             "a dog jumps over the fence"] * 50, path, 300)
    port, jax = _encoders(path)
    texts = ["a dog on the road", "the fence", "a man<extra_id_3> moped",
             "zebra"]
    for g, w in zip(port.encode_batch(texts, 12),
                    jax.encode_batch(texts, 12)):
        np.testing.assert_array_equal(g, w)


def test_encode_follows_the_files_chain_where_the_jax_core_does_not(
        tmp_path):
    """A trained tokenizer.json has no Strip or Replace normalizer: HF
    tokenizers (the JAX ``UnigramTokenizer``) keeps a run of spaces as one
    metaspace each and a trailing space as a token. The port's core follows
    the file; the JAX core applies the spiece.model chain to every file."""
    path = str(tmp_path / "tok.json")
    train_unigram_tokenizer(["a man rides a moped down the road"] * 50,
                            path, 300)
    port, jax = _encoders(path)
    reference = JaxUnigramTokenizer(path)
    texts = ["a  man", "a man ", "a   road  "]
    want = reference(texts, max_length=16)
    got = port.encode_batch(texts, 16)
    np.testing.assert_array_equal(got[0], want.input_ids)
    np.testing.assert_array_equal(got[1], want.attention_mask)
    assert not np.array_equal(jax.encode_batch(texts, 16)[0],
                              want.input_ids)


def test_encode_keeps_nul_and_long_texts(tmp_path):
    """``encode`` and ``encode_batch`` take a text's length (a NUL is a
    character); ``encode`` grows its buffer for a text of more ids than
    bytes."""
    path = write_spm(tmp_path / "spiece.model")
    tok = load_tokenizer(path)
    want = JaxUnigramTokenizer(path).encode_ids("a\0b")
    assert tok.encode_ids("a\0b") == want
    ids, mask = tok.encoder.encode_batch(["a\0b", "\0"], 8, 0, 1)
    assert ids[0, :mask[0].sum()].tolist() == want + [1]
    assert ids[1, :mask[1].sum()].tolist() == tok.encode_ids("\0") + [1]
    long = "Z a " * 500
    ids = tok.encode_ids(long)
    assert ids == JaxUnigramTokenizer(path).encode_ids(long)


def test_spm_proto_matches_jax(tmp_path):
    path = write_spm(tmp_path / "spiece.model",
                     jcharsmap.build_charsmap(CHARSMAP), model_type=1)
    want = jspm.load_model_proto(path)
    got = tspm.load_model_proto(path)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.pieces[3] == ("▁a", pytest.approx(-1.0))


@pytest.mark.parametrize("mapping", [
    CHARSMAP, {"A": "q", "AB": "ab", "é": "e", "①": "1"},
    {chr(0xFF01 + i): chr(0x21 + i) for i in range(60)}])
def test_charsmap_matches_jax(mapping):
    blob = tcharsmap.build_charsmap(mapping)
    assert blob == jcharsmap.build_charsmap(mapping)
    got, want = tcharsmap.parse_charsmap(blob), jcharsmap.parse_charsmap(blob)
    assert (got.units, got.normalized) == (want.units, want.normalized)
    for key in list(mapping) + ["ABC", "zz", "é!"]:
        data = key.encode("utf-8")
        assert got.longest_prefix(data) == want.longest_prefix(data)


def test_failed_build_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("CXX", "/nonexistent/c++")
    with pytest.raises(RuntimeError, match="cannot run the C\\+\\+ compiler"):
        native.build_library(tmp_path / "_build")
    assert list((tmp_path / "_build").iterdir()) == []


def test_no_fallback_where_the_build_fails(tmp_path):
    """With no compiler, the resize, the tokenizer and the image loader all
    raise: nothing falls back to Pillow's resize or to another encoder."""
    from PIL import Image

    img = tmp_path / "x.png"
    Image.new("RGB", (40, 30), (10, 20, 30)).save(img)
    spm = write_spm(tmp_path / "spiece.model")
    code = (
        "import numpy as np\n"
        "from klab_multimodalmodel_tpu_torch import native\n"
        "from klab_multimodalmodel_tpu_torch.data.datasets import "
        "load_image_resized\n"
        "from klab_multimodalmodel_tpu_torch.text import load_tokenizer\n"
        "calls = [lambda: native.resize_batch([np.zeros((4, 4, 3), "
        "np.uint8)], 2),\n"
        f"         lambda: load_image_resized({str(img)!r}, 16),\n"
        f"         lambda: load_tokenizer({spm!r})]\n"
        "for call in calls:\n"
        "    try:\n"
        "        call()\n"
        "    except RuntimeError as e:\n"
        "        assert 'cannot run the C++ compiler' in str(e), e\n"
        "    else:\n"
        "        raise AssertionError('no error')\n")
    env = dict(os.environ, CXX="/nonexistent/c++")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]


def test_package_ships_the_runtime_source():
    """An installed package carries ``klab_host.cpp`` and ``klab_jpeg.cpp``:
    the library is built from them at first use."""
    import tomllib

    with open(ROOT / "pyproject.toml", "rb") as f:
        globs = tomllib.load(f)["tool"]["setuptools"]["package-data"][
            "klab_multimodalmodel_tpu_torch"]
    package = native.SOURCE.parent.parent
    assert native.SOURCE in native.SOURCES and len(native.SOURCES) == 2
    for source in native.SOURCES:
        assert any(source in set(package.glob(g)) for g in globs), source
