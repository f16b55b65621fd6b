"""The HF checkpoint converters of the port (``checkpoint/convert_hf.py``,
``checkpoint/export_hf.py``, ``checkpoint/hf_files.py``) and the
``convert-hf`` / ``export-hf`` commands, on tiny seeded ``transformers``
models written in ``tmp_path``:

- the port's conversion equals ``convert_jax_params`` of the JAX package's
  ``convert_hf`` output, tensor by tensor, bitwise (T5 tied, T5 untied, T5
  v1.1 gated, SwinV2);
- the port's towers loaded from it give the HF models' outputs in fp32 on
  the CPU (T5 logits, SwinV2 ``last_hidden_state``) within 1e-5 relative;
- ``export_hf`` then ``convert_hf`` is bitwise the identity, and HF's
  ``load_state_dict(strict=True)`` takes the export;
- the safetensors reader equals ``safetensors.torch.load_file``;
- a geometry mismatch raises;
- end to end: ``convert-hf`` with ``safetensors`` and ``transformers``
  unimportable, ``train`` from its output with its ``tokenizer.json``,
  ``caption``, then ``export-hf``.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_port as tp
import klab_multimodalmodel_tpu.checkpoint.convert_hf as jconv
import klab_multimodalmodel_tpu.config as jcfg
import klab_multimodalmodel_tpu_torch.config as tcfg
from klab_multimodalmodel_tpu.text.tokenizer import train_unigram_tokenizer
from klab_multimodalmodel_tpu_torch import __main__ as module_main
from klab_multimodalmodel_tpu_torch.checkpoint import convert_hf as conv
from klab_multimodalmodel_tpu_torch.checkpoint import export_hf as export
from klab_multimodalmodel_tpu_torch.checkpoint import from_jax
from klab_multimodalmodel_tpu_torch.checkpoint.hf_files import (
    load_state_dict, read_safetensors)
from klab_multimodalmodel_tpu_torch.checkpoint.io import read_whole
from klab_multimodalmodel_tpu_torch.models.swinv2 import SwinV2Encoder
from klab_multimodalmodel_tpu_torch.models.t5 import (
    T5Encoder, T5ForConditionalGeneration)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
UNTIED = "t5-torchport-tiny-untied"
TINY_UNTIED = dict(tp.TINY_T5, tie_word_embeddings=False)
jcfg.register_t5_size(UNTIED, jcfg.T5Size(**TINY_UNTIED))
tcfg.register_t5_size(UNTIED, tcfg.T5Size(**TINY_UNTIED))
T5_KINDS = {"tied": tp.T5_NAMES["v10"][0], "untied": UNTIED,
            "gated": tp.T5_NAMES["v11"][0]}


def hf_t5(name: str, seed: int = 0):
    from transformers import T5Config, T5ForConditionalGeneration as HF

    s = tcfg.T5Size(**{"t5-torchport-tiny": tp.TINY_T5, UNTIED: TINY_UNTIED,
                       "t5-torchport-tiny-v11": tp.TINY_T5_V11}[name])
    torch.manual_seed(seed)
    model = HF(T5Config(
        vocab_size=s.vocab_size, d_model=s.d_model, d_kv=s.d_kv,
        d_ff=s.d_ff, num_layers=s.num_layers,
        num_decoder_layers=s.num_decoder_layers, num_heads=s.num_heads,
        relative_attention_num_buckets=s.relative_attention_num_buckets,
        relative_attention_max_distance=s.relative_attention_max_distance,
        dropout_rate=0.0, feed_forward_proj=s.feed_forward_proj,
        tie_word_embeddings=s.tie_word_embeddings,
        decoder_start_token_id=0)).eval()
    with torch.no_grad():  # HF's init leaves the layer norms at 1
        for n, p in model.named_parameters():
            if "layer_norm" in n:
                p.uniform_(0.5, 1.5)
    return model, s


def hf_swin(seed: int = 0, **overrides):
    from transformers import Swinv2Config, Swinv2Model

    kw = dict(tp.TINY_SWIN, **overrides)
    torch.manual_seed(seed)
    model = Swinv2Model(Swinv2Config(
        image_size=kw["image_size"], patch_size=kw["patch_size"],
        embed_dim=kw["embed_dim"], depths=list(kw["depths"]),
        num_heads=list(kw["num_heads"]), window_size=kw["window_size"],
        drop_path_rate=0.0,
        pretrained_window_sizes=list(kw["pretrained_window_sizes"]))).eval()
    with torch.no_grad():
        for n, p in model.named_parameters():
            if "norm" in n or "logit_scale" in n:
                p.add_(torch.rand_like(p) * 0.5)
    return model, tcfg.SwinV2Size(**kw)


def _np_sd(sd):
    return {k: v.detach().numpy() for k, v in sd.items()}


def assert_equal_dicts(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        w = torch.as_tensor(np.asarray(want[k]))
        assert got[k].dtype == torch.float32 and got[k].shape == w.shape, k
        assert torch.equal(got[k], w), k


@pytest.mark.parametrize("kind", sorted(T5_KINDS))
def test_t5_conversion_equals_jax(kind):
    model, size = hf_t5(T5_KINDS[kind])
    sd = model.state_dict()
    jsize = jcfg._t5_size(T5_KINDS[kind])
    assert_equal_dicts(conv.convert_t5_lm(sd, size), from_jax.convert_t5_lm(
        jconv.convert_t5_lm(_np_sd(sd), jsize), size))
    assert_equal_dicts(
        conv.convert_t5_encoder(sd, size), from_jax.convert_t5_encoder(
            jconv.convert_t5_encoder(_np_sd(sd), jsize), size))


def test_swinv2_conversion_equals_jax():
    model, size = hf_swin()
    sd = {f"swinv2.{k}": v for k, v in model.state_dict().items()}
    sd["classifier.weight"] = torch.zeros(10, size.num_features)
    want = from_jax.convert_swinv2(jconv.convert_swinv2(
        {k.removeprefix("swinv2."): v for k, v in _np_sd(sd).items()},
        jcfg._swin_size(tp.SWIN_NAME)), size)
    assert_equal_dicts(conv.convert_swinv2(sd, size), want)


@pytest.mark.parametrize("swin_overrides", [{}, dict(embed_dim=8)])
def test_full_conversion_equals_jax_tool(swin_overrides):
    """The assembly of the JAX conversion command: both T5 towers from one
    checkpoint, and the vision projection (the identity where the widths
    agree, else ``default_rng(0)``'s draw)."""
    t5, size = hf_t5(T5_KINDS["tied"])
    swin, swin_size = hf_swin(**swin_overrides)
    name = f"swin-convert-{swin_size.embed_dim}"
    tcfg.register_swin_size(name, swin_size)
    jcfg.register_swin_size(name, jcfg.SwinV2Size(**dataclasses.asdict(
        swin_size)))
    jc, tc = tp.configs("v10", image_model_name=name)
    params = {
        "language_model": jconv.convert_t5_encoder(_np_sd(t5.state_dict()),
                                                   jc.language_t5),
        "transformer": jconv.convert_t5_lm(_np_sd(t5.state_dict()),
                                           jc.transformer_t5),
        "image_model": jconv.convert_swinv2(_np_sd(swin.state_dict()),
                                            jc.swin)}
    vis, d_model = jc.swin.num_features, jc.transformer_t5.d_model
    if vis == d_model:
        params["vision_projection"] = {"kernel": np.eye(d_model,
                                                        dtype=np.float32)}
    else:
        rng = np.random.default_rng(0)
        params["vision_projection"] = {"kernel": (
            rng.standard_normal((vis, d_model)) / np.sqrt(vis)).astype(
                np.float32)}
    want = from_jax.convert_jax_params(params, tc)
    got = conv.convert_hf_checkpoint(t5.state_dict(), swin.state_dict(), tc)
    assert_equal_dicts(got, {k: v.numpy() for k, v in want.items()})


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("kind", sorted(T5_KINDS))
def test_t5_outputs_match_hf(kind):
    model, size = hf_t5(T5_KINDS[kind], seed=1)
    port = T5ForConditionalGeneration(size, device="cpu")
    port.load_state_dict(conv.convert_t5_lm(model.state_dict(), size),
                         strict=True)
    enc = T5Encoder(size, device="cpu")
    enc.load_state_dict(conv.convert_t5_encoder(model.state_dict(), size),
                        strict=True)
    rng = np.random.default_rng(0)
    ids = torch.tensor(rng.integers(3, size.vocab_size, (2, 9)))
    mask = torch.ones_like(ids)
    mask[1, 6:] = 0
    dec = torch.tensor(rng.integers(3, size.vocab_size, (2, 5)))
    with torch.no_grad():
        want = model(input_ids=ids, attention_mask=mask,
                     decoder_input_ids=dec)
        got = port(input_ids=ids, attention_mask=mask,
                   decoder_input_ids=dec)
        got_enc = enc(ids, attention_mask=mask)
    assert _rel(got.logits, want.logits) < 1e-5
    assert _rel(got_enc, want.encoder_last_hidden_state) < 1e-5


def test_swinv2_outputs_match_hf():
    model, size = hf_swin(seed=2)
    port = SwinV2Encoder(size, device="cpu")
    port.load_state_dict(conv.convert_swinv2(model.state_dict(), size),
                         strict=True)
    x = torch.tensor(np.random.default_rng(0).standard_normal(
        (2, 32, 32, 3)), dtype=torch.float32)
    with torch.no_grad():
        want = model(pixel_values=x.permute(0, 3, 1, 2)).last_hidden_state
        got = port(x)
    assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("kind", sorted(T5_KINDS) + ["swinv2"])
def test_export_then_convert_is_identity(kind):
    from transformers import T5EncoderModel

    if kind == "swinv2":
        hf, size = hf_swin(seed=3)
        sd = conv.convert_swinv2(hf.state_dict(), size)
        exported = export.export_swinv2(sd, size)
        hf.load_state_dict(exported, strict=True)
        assert_equal_dicts(conv.convert_swinv2(exported, size), sd)
        return
    hf, size = hf_t5(T5_KINDS[kind], seed=3)
    sd = conv.convert_t5_lm(hf.state_dict(), size)
    exported = export.export_t5_lm(sd, size)
    hf.load_state_dict(exported, strict=True)
    assert_equal_dicts(conv.convert_t5_lm(exported, size), sd)
    enc_sd = conv.convert_t5_encoder(hf.state_dict(), size)
    enc_exported = export.export_t5_encoder(enc_sd, size)
    T5EncoderModel(hf.config).load_state_dict(enc_exported, strict=True)
    assert_equal_dicts(conv.convert_t5_encoder(enc_exported, size), enc_sd)


def test_safetensors_reader_equals_the_package(tmp_path):
    from safetensors.torch import load_file, save_file

    g = torch.Generator().manual_seed(0)
    tensors = {
        "f32": torch.randn(3, 5, generator=g),
        "f16": torch.randn(7, generator=g).half(),
        "bf16": torch.randn(2, 3, 4, generator=g).bfloat16(),
        "i64": torch.arange(-4, 8).reshape(3, 4),
        "scalar": torch.tensor(2.5),
        "empty": torch.zeros(0, 3),
    }
    path = str(tmp_path / "model.safetensors")
    save_file(tensors, path, metadata={"format": "pt"})
    got, want = read_safetensors(path), load_file(path)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        assert torch.equal(got[k], want[k]), k
    assert torch.equal(load_state_dict(str(tmp_path))["bf16"],
                       tensors["bf16"])


@pytest.mark.parametrize("change,match", [
    (dict(num_layers=3), "missing"),
    (dict(d_ff=128), "another shape"),
    (dict(num_layers=1), "unexpected"),
    (dict(feed_forward_proj="gated-gelu"), "un-gated"),
])
def test_geometry_mismatch_raises(change, match):
    model, size = hf_t5(T5_KINDS["tied"])
    other = dataclasses.replace(size, **change)
    with pytest.raises(ValueError, match=match):
        conv.convert_t5_lm(model.state_dict(), other)


def test_swinv2_geometry_mismatch_raises():
    model, size = hf_swin()
    with pytest.raises(ValueError, match="SwinV2"):
        conv.convert_swinv2(model.state_dict(),
                            dataclasses.replace(size, depths=(2, 4)))


# ---------------------------------------------------------------------------
# The commands end to end
# ---------------------------------------------------------------------------


def _run_module(argv, blocked=()):
    """``python -m klab_multimodalmodel_tpu_torch *argv`` in a fresh
    interpreter with the tiny geometries registered and ``blocked``
    packages unimportable."""
    code = (
        "import runpy, sys\n"
        f"for name in {tuple(blocked)!r}:\n"
        "    sys.modules[name] = None\n"
        "import klab_multimodalmodel_tpu_torch.config as c\n"
        f"c.register_t5_size({tp.T5_NAMES['v10'][0]!r}, "
        f"c.T5Size(**{tp.TINY_T5!r}))\n"
        f"c.register_swin_size({tp.SWIN_NAME!r}, "
        f"c.SwinV2Size(**{tp.TINY_SWIN!r}))\n"
        f"sys.argv = ['klab_multimodalmodel_tpu_torch', *{list(argv)!r}]\n"
        "runpy.run_module('klab_multimodalmodel_tpu_torch', "
        "run_name='__main__')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def test_convert_train_caption_export_end_to_end(tmp_path, capsys):
    from PIL import Image
    from transformers import T5EncoderModel

    from klab_multimodalmodel_tpu_torch.infer.captioner import Captioner
    from klab_multimodalmodel_tpu_torch.text import load_tokenizer
    from klab_multimodalmodel_tpu_torch.train import train

    t5, _ = hf_t5(T5_KINDS["tied"], seed=4)
    swin, _ = hf_swin(seed=4)
    t5_dir, swin_dir = tmp_path / "t5", tmp_path / "swin"
    t5.save_pretrained(t5_dir, safe_serialization=True)
    swin.save_pretrained(swin_dir, safe_serialization=False)
    assert (t5_dir / "model.safetensors").exists()
    assert (swin_dir / "pytorch_model.bin").exists()
    train_unigram_tokenizer(
        ["a man rides a moped down the road", "a dog jumps over the fence",
         "What does th image describe ?"] * 40,
        str(t5_dir / "tokenizer.json"), vocab_size=300)

    names = ["--language_model_name", tp.T5_NAMES["v10"][0],
             "--transformer_model_name", tp.T5_NAMES["v10"][0],
             "--image_model_name", tp.SWIN_NAME]
    out = tmp_path / "converted"
    printed = _run_module(["convert-hf", "--t5_dir", str(t5_dir),
                           "--swin_dir", str(swin_dir), *names, "--output",
                           str(out)], blocked=("safetensors",
                                               "transformers"))
    assert "wrote" in printed and "GB" in printed
    _, tc = tp.configs("v10")
    saved = torch.load(out / "checkpoints" / "pretrained" / "model.pt",
                       weights_only=True)
    assert_equal_dicts(saved, conv.convert_hf_checkpoint(
        t5.state_dict(), swin.state_dict(), tc))
    tok_path = str(out / "tokenizer.json")
    assert os.path.exists(tok_path)

    cfg = dataclasses.replace(
        tc, init_checkpoint=str(out), tokenizer_path=tok_path,
        native_tokenizer=True, data_dir="synthetic", batch_size=64,
        num_epochs=1, max_target_length=16, result_dir=str(tmp_path / "run"))
    result = train(cfg, device="cpu")
    assert int(result["steps"]) == 1
    assert all(np.isfinite(v) for v in result["losses"]["train"])
    # The frozen text tower is the converted one, bitwise.
    frozen = result["trainer"].model.language_model.state_dict()
    for k, v in frozen.items():
        assert torch.equal(v.float(), saved[f"language_model.{k}"]), k

    img = tmp_path / "img.png"
    Image.new("RGB", (44, 36), color=(200, 30, 30)).save(img)
    run = str(tmp_path / "run")
    capsys.readouterr()
    assert module_main.main(["caption", str(img), "--result_dir", run,
                             "--max_length", "6", "--device", "cpu"]) == 0
    line = capsys.readouterr().out.rstrip("\n")
    state = read_whole(os.path.join(run, "checkpoints", "best"))
    cap = Captioner(cfg, state, load_tokenizer(tok_path), device="cpu")
    from klab_multimodalmodel_tpu_torch.data.datasets import (
        load_image_resized)
    want = cap.caption(load_image_resized(str(img), 32)[None], max_length=6)
    assert line == f"{img}\t{want[0]}"

    exp = tmp_path / "exported"
    assert module_main.main(["export-hf", "--result_dir", run, *names,
                             "--output", str(exp)]) == 0
    t5.load_state_dict(torch.load(exp / "transformer" / "pytorch_model.bin",
                                  weights_only=True), strict=True)
    T5EncoderModel(t5.config).load_state_dict(torch.load(
        exp / "language_model" / "pytorch_model.bin", weights_only=True),
        strict=True)
    swin.load_state_dict(torch.load(exp / "image_model" / "pytorch_model.bin",
                                    weights_only=True), strict=True)
    for k, v in t5.state_dict().items():
        if "embed_tokens" not in k and k != "lm_head.weight":
            assert torch.equal(v, state[f"transformer.{k}"]), k
    proj = torch.load(exp / "vision_projection.bin", weights_only=True)
    assert torch.equal(proj["weight"], state["vision_projection.weight"])
