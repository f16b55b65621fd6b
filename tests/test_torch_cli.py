"""The port's command line and the training loop's caption evaluation.

- ``parse_arguments`` against the JAX package's: every flag with the same
  name, default and choices; the flags of each ``run_scripts/*/*.sh`` give
  equal values in every field both configs have; a flag the port cannot
  honour raises ``NotImplementedError`` naming its ROADMAP item.
- ``train``, ``eval`` and ``caption`` end to end with ``--device cpu`` on a
  tiny run over a COCO-layout directory of JPEGs (``python -m`` for
  ``caption``); the ``klab-torch-*`` console scripts resolve to them.
- ``serve``: its parser against the JAX ``klab-serve``'s on the same argv,
  its refusals (``--continuous`` with ``--replicas`` or with
  ``--speculative_draft``, more replicas than devices, a negative draft),
  and ``python -m ... serve`` end to end in a subprocess: one
  ``/caption``, then SIGTERM drains.
- The loop's caption evaluation (``eval_captions_every``): its ``cider_d``
  and ``bleu4`` in ``metrics.jsonl`` equal ``evaluate_captions`` (and the
  ``eval`` command) on the same weights; it draws nothing from the step
  generator (parameters and losses equal a run without it, bitwise); a
  halted and resumed run with it on equals the uninterrupted one, bitwise.
"""

import base64
import dataclasses
import glob
import json
import os
import pathlib
import shlex
import subprocess
import sys
import tomllib

import numpy as np
import pytest
import torch

import _torch_port as tp
import klab_multimodalmodel_tpu.config as jcfg
import klab_multimodalmodel_tpu_torch.config as tcfg
from klab_multimodalmodel_tpu_torch import cli
from klab_multimodalmodel_tpu_torch import __main__ as module_main
from klab_multimodalmodel_tpu_torch.checkpoint.io import read_whole
from klab_multimodalmodel_tpu_torch.evaluation import (coco_references,
                                                       evaluate_captions)
from klab_multimodalmodel_tpu_torch.infer.captioner import Captioner
from klab_multimodalmodel_tpu_torch.text import ByteTokenizer
from klab_multimodalmodel_tpu_torch.train import train

ROOT = pathlib.Path(__file__).resolve().parent.parent
SCRIPTS = sorted(ROOT.glob("run_scripts/*/*.sh"))
DROP_T5 = "t5-torchport-tiny-dropout"
tcfg.register_t5_size(DROP_T5, tcfg.T5Size(**dict(tp.TINY_T5,
                                                  dropout_rate=0.1)))


def _script_argv(path: pathlib.Path) -> list[str]:
    """The flags after ``python train.py`` in a run script."""
    text = path.read_text().replace("\\\n", " ")
    line = next(ln for ln in text.splitlines()
                if ln.strip().startswith("python train.py"))
    return shlex.split(line)[2:]


def _actions(parser):
    return {a.dest: a for a in parser._actions if a.dest != "help"}


def test_parser_flags_match_jax():
    """Every JAX flag, with its default, type, nargs and choices (the
    model-name choices are the registries, which hold more names in the
    JAX package when other tests registered some)."""
    want, got = (_actions(jcfg.build_arg_parser()),
                 _actions(tcfg.build_arg_parser()))
    assert got.keys() == want.keys()
    for dest, w in want.items():
        g = got[dest]
        assert g.option_strings == w.option_strings, dest
        assert (g.default, g.type, g.nargs, g.const) == (
            w.default, w.type, w.nargs, w.const), dest
        if dest.endswith("_model_name") and w.choices:
            assert set(tcfg.T5_SIZES) <= set(g.choices), dest
        else:
            assert g.choices == w.choices, dest


def _shared_fields(jc, tc):
    names = [f.name for f in dataclasses.fields(tc)]
    assert set(names) <= {f.name for f in dataclasses.fields(jc)}
    return {n: (getattr(jc, n), getattr(tc, n)) for n in names}


@pytest.mark.parametrize("script", SCRIPTS,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_parse_arguments_matches_jax_on_run_scripts(script):
    argv = _script_argv(script)
    want = jcfg.parse_arguments(argv)
    refused = [f"--{name}" for name, (default, _) in
               tcfg.UNPORTED_FLAGS.items()
               if getattr(want, name) != default]
    if refused:
        with pytest.raises(NotImplementedError, match="ROADMAP") as err:
            tcfg.parse_arguments(argv)
        for flag in refused:
            assert flag in str(err.value), (flag, str(err.value))
        return
    for name, (w, g) in _shared_fields(
            want, tcfg.parse_arguments(argv)).items():
        assert w == g, name


def test_defaults_match_jax():
    for name, (w, g) in _shared_fields(jcfg.parse_arguments([]),
                                       tcfg.parse_arguments([])).items():
        assert w == g, name


@pytest.mark.parametrize("argv,item", [
    ("--mesh_shape 1 2 1 1 1 1", None),
    ("--dcn_mesh_shape 1 1 2 1 1 1", None),
    ("--mesh_shape 1 2 2 1 1 1 --moe_experts 2", None),
    ("--mesh_shape 1 1 2 --pipeline_stages 2", None),
    ("--mesh_shape 1 2 1 1 2 1 --pipeline_stages 2", None),
    ("--mesh_shape 1 2 2 1 1 1 --pipeline_stages 2", None),
    ("--mesh_shape 1 1 2 1 2 1 --pipeline_stages 2", None),
    ("--mesh_shape 1 2 1 1 1 2 --moe_experts 2", None),
    ("--mesh_shape 1 2 -1 1 1 2 --moe_experts 4", None),
    ("--dcn_mesh_shape 1 2 1 1 1 2 --moe_experts 2", None),
    ("--mesh_shape 1 1 1 2 1 2 --moe_experts 2", None),
    ("--mesh_shape 2 1 1 1 2 1 --pipeline_stages 2", None),
    ("--scan_unroll 2", "not ported by design"),
    ("--seq_attention ring", None),
    ("--mesh_shape 1 1 1 2", None),
    ("--mesh_shape 1 1 1 2 --seq_attention ring", None),
    ("--mesh_shape 1 2 1 2", None),
    ("--mesh_shape 1 1 2 2 --seq_attention ring", None),
    ("--dcn_mesh_shape 1 2 2 2", None),
    ("--mesh_shape 1 1 1 2 --moe_experts 2", None),
    ("--pipeline_stages 2 --seq_attention ring", ValueError),
    ("--pipeline_stages 2 --use_pallas_t5_attention", ValueError),
    ("--pipeline_stages 2 --pipeline_microbatches 4", None),
    ("--moe_experts 2 --moe_top_k 3", ValueError),
    ("--moe_experts 2 --moe_capacity_factor 2.0", None),
    ("--moe_experts 2 --moe_aux_loss_weight 0.1", None),
    ("--moe_experts 8 --mesh_shape 1 1 1 1 1 2", None),
    ("--moe_experts 6 --mesh_shape 1 1 1 1 1 4", ValueError),
    ("--mesh_shape 1 1 1 1 2 1", ValueError),
    ("--profile_server_port 9012", "no live profiler server")])
def test_unported_flag_raises_naming_its_item(argv, item):
    """A flag the port does not honour raises ``NotImplementedError``
    naming its ROADMAP item or why it is not ported; a pipeline, MoE or
    mesh value the JAX package refuses raises its ``ValueError`` with its
    message (``item`` ValueError); the ported flags, the pipe and expert
    axes and MoE under the seq axis (beside the expert axis too) among
    them, parse as the JAX package parses them (``item`` None)."""
    argv = shlex.split(argv)
    if item is ValueError:
        with pytest.raises(ValueError) as want:
            jcfg.parse_arguments(argv)
        with pytest.raises(ValueError) as got:
            tcfg.parse_arguments(argv)
        assert str(got.value) == str(want.value)
        return
    want = jcfg.parse_arguments(argv)  # a valid JAX command line
    if item is None:
        for name, (w, g) in _shared_fields(
                want, tcfg.parse_arguments(argv)).items():
            assert w == g, name
        return
    with pytest.raises(NotImplementedError, match=item):
        tcfg.parse_arguments(argv)


# The flags an axis above 1 needs to parse (its own refusals aside).
AXIS_FLAGS = {"FSDP": [], "TENSOR": [], "SEQ": [],
              "PIPE": ["--pipeline_stages", "2"],
              "EXPERT": ["--moe_experts", "2"]}
AXES = list(AXIS_FLAGS)


def _mesh_argv(*axes: str) -> list[str]:
    shape = [1] + [2 if a in axes else 1 for a in AXES]
    flags = [f for a in axes for f in AXIS_FLAGS[a]]
    return ["--mesh_shape", *map(str, shape), *flags]


def test_mesh_help_names_what_the_jax_package_refuses():
    """``--mesh_shape``'s help names, after "refused", exactly the pairs of
    axes above 1 (with the flags each needs) that the parser refuses: every
    pair it names raises the JAX package's ValueError, word for word, and
    every pair it does not name (the expert axis beside seq among them)
    parses as the JAX parser parses it, also with MoE under a seq axis
    alone. No pair names a ROADMAP item."""
    import re

    mesh = next(a.help for a in tcfg.build_arg_parser()._actions
                if "--mesh_shape" in a.option_strings)
    assert "ROADMAP" not in mesh
    refused = mesh[mesh.index("refused"):]
    named = set()
    for part in re.split(r"(?=\b[A-Z]+ beside )", refused):
        m = re.match(r"([A-Z]+) beside (.*)", part)
        if m:
            named |= {(m.group(1), b) for b in re.findall(
                r"\b[A-Z]+\b", m.group(2).split(" and ")[0])}
    assert named == {("PIPE", "SEQ"), ("PIPE", "EXPERT")}
    for i, a in enumerate(AXES):
        for b in AXES[i + 1:]:
            argv = _mesh_argv(a, b)
            if (a, b) in named or (b, a) in named:
                with pytest.raises(ValueError) as want:
                    jcfg.parse_arguments(argv)
                with pytest.raises(ValueError) as got:
                    tcfg.parse_arguments(argv)
                assert str(got.value) == str(want.value), (a, b)
                continue
            want = jcfg.parse_arguments(argv)
            for name, (w, g) in _shared_fields(
                    want, tcfg.parse_arguments(argv)).items():
                assert w == g, (a, b, name)
    argv = _mesh_argv("SEQ") + AXIS_FLAGS["EXPERT"]
    for name, (w, g) in _shared_fields(jcfg.parse_arguments(argv),
                                       tcfg.parse_arguments(argv)).items():
        assert w == g, name


@pytest.mark.parametrize("flags", ["--tokenizer_path {path}",
                                   "--native_tokenizer --tokenizer_path "
                                   "{path}"])
def test_tokenizer_flags_parse_and_run(tmp_path, flags):
    """``--tokenizer_path`` (a spiece.model) and ``--native_tokenizer``
    parse as the JAX package parses them, and the loader that ``train``
    builds from them encodes the COCO prompt as the JAX tokenizer does."""
    from klab_multimodalmodel_tpu.text import load_tokenizer as jax_load
    from klab_multimodalmodel_tpu_torch.data import get_dataloader
    from klab_multimodalmodel_tpu_torch.text import load_tokenizer
    from test_torch_text_unigram import write_spm

    path = write_spm(tmp_path / "spiece.model")
    argv = shlex.split(flags.format(path=path)) + [
        "--image_model_name", tp.SWIN_NAME, "--data_dir", "synthetic",
        "--batch_size", "2", "--max_source_length", "16"]
    got = tcfg.parse_arguments(argv)
    for name, (w, g) in _shared_fields(jcfg.parse_arguments(argv),
                                       got).items():
        assert w == g, name
    assert got.tokenizer_path == path
    loader = get_dataloader(got, "train", load_tokenizer(got.tokenizer_path))
    loader.set_epoch(1)
    batch = next(iter(loader))
    want = jax_load(path)(["What does th image describe ?"] * 2,
                          max_length=16)
    np.testing.assert_array_equal(batch["source_ids"], want.input_ids)
    np.testing.assert_array_equal(batch["source_mask"], want.attention_mask)


def test_entry_points_resolve():
    with open(ROOT / "pyproject.toml", "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    want = {"klab-torch-train": cli.main, "klab-torch-eval": cli.eval_main,
            "klab-torch-caption": cli.caption_main,
            "klab-torch-convert-hf": cli.convert_hf_main,
            "klab-torch-export-hf": cli.export_hf_main,
            "klab-torch-serve": cli.serve_main}
    for name, fn in want.items():
        module, attr = scripts[name].split(":")
        assert module == "klab_multimodalmodel_tpu_torch.cli"
        assert getattr(cli, attr) is fn
    assert module_main.COMMANDS["train"] is cli.main
    assert module_main.COMMANDS["convert-hf"] is cli.convert_hf_main
    assert module_main.COMMANDS["export-hf"] is cli.export_hf_main
    assert module_main.main([]) == 2
    assert module_main.main(["nope"]) == 2
    assert module_main.COMMANDS["serve"] is cli.serve_main


# ---------------------------------------------------------------------------
# End to end on a tiny COCO run
# ---------------------------------------------------------------------------

REFS = ["a red square on a wall", "two dogs in a field", "a plate of food",
        "a man on a bike", "a small boat"]


def _coco_dir(root: pathlib.Path) -> str:
    """COCO layout: 4 train and 3 val JPEGs of seeded noise; val images
    carry two captions each."""
    from PIL import Image

    d = root / "mscoco2017"  # the dataset is chosen by this name
    (d / "annotations").mkdir(parents=True)
    rng = np.random.default_rng(0)
    for phase, n in (("train", 4), ("val", 3)):
        (d / f"{phase}2017").mkdir()
        images, anns = [], []
        for i in range(n):
            name = f"{i:012d}.jpg"
            Image.fromarray(rng.integers(0, 256, (40, 48, 3), dtype=np.uint8)
                            ).save(d / f"{phase}2017" / name)
            images.append({"id": i, "file_name": name})
            for j in range(2):
                anns.append({"id": 10 * i + j, "image_id": i,
                             "caption": REFS[(i + j) % len(REFS)]})
        with open(d / "annotations" / f"captions_{phase}2017.json",
                  "w") as f:
            json.dump({"images": images, "annotations": anns}, f)
    return str(d)


FLAGS = dict(image_model_name=tp.SWIN_NAME, language_model_name=DROP_T5,
             transformer_model_name=DROP_T5, max_source_length=32,
             max_target_length=16, batch_size=2, num_epochs=2,
             save_interval=1, generate_max_length=8, eval_captions_every=1,
             eval_captions_limit=3)


def _argv(**flags) -> list[str]:
    out = []
    for k, v in flags.items():
        out += [f"--{k}"] if v is True else [f"--{k}", str(v)]
    return out


def _rows(result_dir):
    """metrics.jsonl without its wall-clock fields."""
    with open(os.path.join(result_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    for r in rows:
        for k in ("img_per_sec", "epoch_seconds"):
            r.pop(k)
    return rows


def _state(result_dir, name):
    return read_whole(os.path.join(result_dir, "checkpoints", name))


@pytest.fixture(scope="module")
def run_a(tmp_path_factory):
    """The uninterrupted run, through the train command: 2 epochs of 2
    updates, bf16 compute, dropout on, the caption evaluation every epoch,
    TensorBoard on."""
    root = tmp_path_factory.mktemp("cli")
    data = _coco_dir(root)
    result = str(root / "a")
    cli.main(_argv(**FLAGS, data_dir=data, result_dir=result,
                   use_pallas_attention=True, use_pallas_t5_attention=True,
                   tensorboard=True) + ["--device", "cpu"])
    return root, data, result


def test_loop_caption_scores_equal_evaluate_captions(run_a, capsys):
    """Each epoch's row holds cider_d and bleu4; the last equals
    evaluate_captions on the epoch_2 weights (a fresh fp32 Captioner,
    where the loop wrapped the trainer's bf16 model), and the eval command
    prints and writes the same metrics."""
    _, data, result = run_a
    rows = _rows(result)
    assert [r["epoch"] for r in rows] == [1, 2]
    assert all(np.isfinite([r["cider_d"], r["bleu4"]]).all() for r in rows)
    with open(os.path.join(result, "config.json")) as f:
        config = tcfg.Config.from_json(f.read())
    assert config.compute_dtype == "bfloat16"
    paths, refs = coco_references(data)
    want = evaluate_captions(config, _state(result, "epoch_2"),
                             ByteTokenizer(), paths, refs, limit=3,
                             device="cpu")
    assert (rows[-1]["cider_d"], rows[-1]["bleu4"]) == (
        want["CIDEr-D"], want["BLEU-4"])
    capsys.readouterr()
    cli.eval_main(["--result_dir", result, "--checkpoint", "epoch_2",
                   "--limit", "3", "--device", "cpu"])
    printed = json.loads(capsys.readouterr().out)
    assert printed == want
    with open(os.path.join(result, "metrics.json")) as f:
        assert json.load(f) == want
    with open(os.path.join(result, "train.log")) as f:
        assert f.read().count("CIDEr-D : ") == 2
    assert glob.glob(os.path.join(result, "tb", "events.*"))


def test_loop_caption_evaluation_draws_nothing_and_resumes_exactly(run_a):
    """Without the evaluation, the same run gives the same weights and
    losses bitwise; halted after update 3 and rerun, it gives the
    uninterrupted run's weights and metrics rows bitwise."""
    root, data, result = run_a
    base = tcfg.parse_arguments(_argv(**FLAGS, data_dir=data,
                                      use_pallas_attention=True,
                                      use_pallas_t5_attention=True))
    off = train(dataclasses.replace(base, eval_captions_every=0,
                                    result_dir=str(root / "off")),
                device="cpu")
    halted = dataclasses.replace(base, halt_after_steps=3,
                                 result_dir=str(root / "b"))
    b1 = train(halted, device="cpu")
    assert b1["halted"] and int(b1["steps"]) == 3
    b2 = train(halted, device="cpu")
    assert not b2["halted"]
    want = _state(result, "epoch_2")
    for other in (str(root / "off"), str(root / "b")):
        got = _state(other, "epoch_2")
        assert got.keys() == want.keys()
        for k in want:
            assert torch.equal(got[k], want[k]), (other, k)
    assert off["losses"] == b2["losses"]
    assert _rows(str(root / "b")) == _rows(result)
    assert all("cider_d" not in r for r in _rows(str(root / "off")))


def test_caption_command_and_python_m(run_a, capsys, tmp_path):
    """``caption`` prints one ``path<TAB>caption`` line per image, equal to
    Captioner.caption on the same weights; ``python -m`` runs it too."""
    from PIL import Image

    _, _, result = run_a
    imgs = []
    for i, color in enumerate([(200, 30, 30), (20, 90, 160)]):
        p = tmp_path / f"img{i}.png"
        Image.new("RGB", (44, 36), color=color).save(p)
        imgs.append(str(p))
    with open(os.path.join(result, "config.json")) as f:
        config = tcfg.Config.from_json(f.read())
    cap = Captioner(config, _state(result, "best"), ByteTokenizer(),
                    device="cpu")
    from klab_multimodalmodel_tpu_torch.data.datasets import (
        load_image_resized)
    want = cap.caption(np.stack([load_image_resized(p, 32) for p in imgs]),
                       num_beams=2, max_length=6)
    argv = ["caption", *imgs, "--result_dir", result, "--num_beams", "2",
            "--max_length", "6", "--device", "cpu"]
    capsys.readouterr()
    assert module_main.main(argv) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines == [f"{p}\t{t}" for p, t in zip(imgs, want)]

    # The same through ``python -m`` in a fresh interpreter (which has to
    # register the tiny geometries the run's config names first).
    code = (
        "import runpy, sys\n"
        "import klab_multimodalmodel_tpu_torch.config as c\n"
        f"c.register_t5_size({DROP_T5!r}, "
        f"c.T5Size(**{dict(tp.TINY_T5, dropout_rate=0.1)!r}))\n"
        f"c.register_swin_size({tp.SWIN_NAME!r}, "
        f"c.SwinV2Size(**{tp.TINY_SWIN!r}))\n"
        f"sys.argv = ['klab_multimodalmodel_tpu_torch', *{argv!r}]\n"
        "runpy.run_module('klab_multimodalmodel_tpu_torch', "
        "run_name='__main__')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.splitlines() == lines


# ---------------------------------------------------------------------------
# serve
# ---------------------------------------------------------------------------


class _Parsed(Exception):
    def __init__(self, parser, argv):
        self.parser, self.argv = parser, argv


def _jax_serve_parser(monkeypatch):
    """The JAX ``serve_main``'s parser (it builds its parser inside the
    function and parses ``sys.argv``): caught at ``parse_args``."""
    import argparse

    from klab_multimodalmodel_tpu import cli as jcli

    def catch(self, args=None, namespace=None):
        raise _Parsed(self, args)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", catch)
    with pytest.raises(_Parsed) as caught:
        jcli.serve_main()
    monkeypatch.undo()
    return caught.value.parser


SERVE_ARGV = ["--result_dir", "r", "--checkpoint", "epoch_2", "--host",
              "127.0.0.1", "--port", "0", "--max_batch", "4",
              "--batch_window_ms", "2.5", "--no_warmup", "--int8",
              "--speculative_draft", "3", "--max_gen_length", "64",
              "--stream_chunk", "2", "--replicas", "1", "--continuous",
              "--slots", "8", "--engine_chunk", "2"]


def test_serve_parser_matches_jax(monkeypatch):
    """Every JAX ``klab-serve`` flag with its default, type, nargs, const
    and choices, plus ``--device``; the same argv parses to the same
    values."""
    want = _actions(_jax_serve_parser(monkeypatch))
    got = _actions(cli.serve_parser())
    assert got.keys() - want.keys() == {"device"}
    for dest, w in want.items():
        g = got[dest]
        assert (g.option_strings, g.default, g.type, g.nargs, g.const,
                g.choices, g.required) == (
            w.option_strings, w.default, w.type, w.nargs, w.const,
            w.choices, w.required), dest
    jargs = _jax_serve_parser(monkeypatch).parse_args(SERVE_ARGV)
    targs = cli.serve_parser().parse_args(SERVE_ARGV)
    assert vars(targs) == dict(vars(jargs), device=None)


@pytest.mark.parametrize("flags,message", [
    (["--continuous", "--replicas", "2"], "--continuous with --replicas"),
    (["--continuous", "--speculative_draft", "2"],
     "--continuous with --speculative_draft .* one token per slot"),
    (["--replicas", "2"], "--replicas 2 > 1 visible devices"),
])
def test_serve_refusals(flags, message):
    with pytest.raises(SystemExit, match=message):
        cli.serve_main(["--result_dir", "absent", "--device", "cpu",
                        *flags])


def test_serve_refuses_a_negative_draft(capsys):
    with pytest.raises(SystemExit) as err:
        cli.serve_main(["--result_dir", "absent", "--device", "cpu",
                        "--speculative_draft", "-1"])
    assert err.value.code == 2
    assert "--speculative_draft must be >= 0" in capsys.readouterr().err


def test_serve_main_end_to_end_in_a_subprocess(run_a, tmp_path):
    """``python -m ... serve`` on the tiny run: it binds, warms, answers one
    ``/caption`` with the Captioner's caption of the same bytes, and drains
    on SIGTERM (exit code 0)."""
    import queue
    import signal
    import threading

    from klab_multimodalmodel_tpu_torch.data.datasets import (
        load_image_bytes_resized)

    _, _, result = run_a
    png = tp.png_bytes(np.random.default_rng(9))
    with open(os.path.join(result, "config.json")) as f:
        config = tcfg.Config.from_json(f.read())
    cap = Captioner(config, _state(result, "best"), ByteTokenizer(),
                    device="cpu")
    want = cap.caption(load_image_bytes_resized(png, 32)[None])[0]

    argv = ["serve", "--result_dir", result, "--host", "127.0.0.1",
            "--port", "0", "--max_batch", "2", "--device", "cpu"]
    code = (
        "import runpy, sys\n"
        "import klab_multimodalmodel_tpu_torch.config as c\n"
        f"c.register_t5_size({DROP_T5!r}, "
        f"c.T5Size(**{dict(tp.TINY_T5, dropout_rate=0.1)!r}))\n"
        f"c.register_swin_size({tp.SWIN_NAME!r}, "
        f"c.SwinV2Size(**{tp.TINY_SWIN!r}))\n"
        f"sys.argv = ['klab_multimodalmodel_tpu_torch', *{argv!r}]\n"
        "runpy.run_module('klab_multimodalmodel_tpu_torch', "
        "run_name='__main__')\n")
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    lines = queue.Queue()
    threading.Thread(target=lambda: [lines.put(ln) for ln in proc.stdout],
                     daemon=True).start()

    def line_with(text):
        while True:
            ln = lines.get(timeout=120)
            if text in ln:
                return ln

    try:
        port = int(line_with("listening on").split(":")[-1].split()[0])
        line_with("ready")
        base = f"http://127.0.0.1:{port}"
        assert tp.http_get(base, "/healthz") == (200, {"status": "ok"})
        status, body = tp.http_post(
            base, "/caption", {"image_b64": base64.b64encode(png).decode()})
        assert (status, body) == (200, {"caption": want})
        proc.send_signal(signal.SIGTERM)
        assert "draining" in line_with("SIGTERM")
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
