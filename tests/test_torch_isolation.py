"""The port stands alone: it imports no ``jax`` and nothing of the JAX
package, and neither does ``chip_smoke.py``; no file of either names the
repo-root ``native/`` directory or its ``libklab_host.so``, and the port's
own C++ runtime builds under ``_build/`` only."""

import ast
import os
import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "klab_multimodalmodel_tpu_torch"
PORT_MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(
        ".__init__")
    for p in PORT.rglob("*.py"))
JAX_PACKAGE = "klab_multimodalmodel_tpu"


def _imported_names(path: pathlib.Path) -> list[tuple[str, int]]:
    """(module, level) of every import statement in a source file."""
    out = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out += [(a.name, 0) for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            out.append((node.module or "", node.level))
    return out


def test_port_has_modules():
    assert f"{PORT.name}.infer.captioner" in PORT_MODULES
    assert f"{PORT.name}.ops.fused_attention" in PORT_MODULES
    assert f"{PORT.name}.parallel.partitioning" in PORT_MODULES
    assert f"{PORT.name}.ops.ring_attention" in PORT_MODULES


def test_every_port_module_imports_without_jax():
    """Each module imports in a fresh interpreter where ``import jax`` and
    any import of the JAX package fail."""
    code = (
        "import sys\n"
        f"for name in ('jax', 'jaxlib', 'flax', {JAX_PACKAGE!r}):\n"
        "    sys.modules[name] = None\n"
        "import importlib\n"
        f"for mod in {PORT_MODULES!r}:\n"
        "    importlib.import_module(mod)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"('jax', 'jaxlib', 'flax', {JAX_PACKAGE!r}) "
        "and sys.modules[m] is not None]\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_names_the_jax_package(path):
    text = path.read_text()
    assert f"{JAX_PACKAGE}." not in text
    for module, level in _imported_names(path):
        top = module.split(".")[0]
        assert top not in ("jax", "jaxlib", "flax", JAX_PACKAGE), module
        # A relative import may not climb out of the port's package.
        if level and path.parent != ROOT:
            depth = len(path.relative_to(PORT).parts) - 1
            assert level <= depth + 1, (module, level)


# A path into the repo-root native/ directory: "native/" not preceded by the
# port's package name, or a string literal that is the directory itself.
ROOT_NATIVE = re.compile(r"(?<!klab_multimodalmodel_tpu_torch/)\bnative/")
PORT_FILES = sorted(p for p in PORT.rglob("*") if p.is_file()
                    and p.suffix in (".py", ".cpp", ".cu", ".cuh")
                    and "_build" not in p.parts)


@pytest.mark.parametrize("path", PORT_FILES + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_file_names_the_root_native_runtime(path):
    text = path.read_text()
    assert "libklab_host.so" not in text
    assert not ROOT_NATIVE.search(text), ROOT_NATIVE.search(text)
    if path.suffix == ".py":
        for node in ast.walk(ast.parse(text)):
            if isinstance(node, ast.Constant) and isinstance(node.value, str):
                assert node.value.strip("/") != "native", node.lineno


def _tree(root: pathlib.Path, outputs: tuple = ()) -> dict:
    """(size, mtime) of every file under ``root``, the build and cache
    directories and the files named in ``outputs`` left out."""
    out = {}
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames if d not in (
            "_build", "__pycache__")]
        for name in filenames:
            if name in outputs:
                continue
            st = os.stat(os.path.join(dirpath, name))
            out[os.path.join(dirpath, name)] = (st.st_size, st.st_mtime_ns)
    return out


def test_native_build_writes_only_under_build(tmp_path):
    """The port's library comes from its own ``klab_host.cpp`` and lands in
    the given build directory: the port's tree and the repo-root
    ``native/`` are untouched by a build."""
    from klab_multimodalmodel_tpu_torch import native

    assert native.SOURCE.parent == PORT / "native"
    assert native.BUILD_DIR == PORT / "_build"
    assert native.library_path().parent == PORT / "_build"
    # The JAX package's own build output (its Makefile's target) may appear
    # meanwhile: other test processes build it through the JAX package.
    jax_outputs = ("libklab_host.so",)
    before = (_tree(PORT), _tree(ROOT / "native", jax_outputs))
    build = tmp_path / "_build"
    lib = native.build_library(build)
    assert lib.parent == build and lib.exists()
    assert [p.name for p in build.iterdir()] == [lib.name]
    assert (_tree(PORT), _tree(ROOT / "native", jax_outputs)) == before


# Optional packages, which a CUDA host need not have: nothing the port
# imports at module level, and nothing on the synthetic training path, may
# need them.
OPTIONAL = ("PIL", "matplotlib", "tensorboard", "ml_dtypes")


def test_synthetic_training_needs_no_optional_package(tmp_path):
    """Every module imports, and a tiny ``train()`` on the synthetic dataset
    runs one epoch end to end (data, cache, checkpoint, logs), in an
    interpreter where jax, the JAX package, Pillow, matplotlib, tensorboard
    and ml_dtypes fail to import."""
    code = (
        "import sys\n"
        f"for name in ('jax', 'jaxlib', 'flax', {JAX_PACKAGE!r}) + "
        f"{OPTIONAL!r}:\n"
        "    sys.modules[name] = None\n"
        "import importlib\n"
        f"for mod in {PORT_MODULES!r}:\n"
        "    importlib.import_module(mod)\n"
        "from klab_multimodalmodel_tpu_torch import config as c\n"
        "from klab_multimodalmodel_tpu_torch.train import train\n"
        "c.register_t5_size('t', c.T5Size(d_model=32, d_kv=8, d_ff=64, "
        "num_layers=1, num_decoder_layers=1, num_heads=4, vocab_size=512, "
        "relative_attention_num_buckets=8, relative_attention_max_distance=16))\n"
        "c.register_swin_size('s', c.SwinV2Size(image_size=32, embed_dim=16, "
        "depths=(2, 2), num_heads=(2, 4), window_size=4))\n"
        "cfg = c.Config(image_model_name='s', language_model_name='t', "
        "transformer_model_name='t', max_source_length=32, "
        "max_target_length=16, batch_size=32, num_epochs=1, "
        "data_dir='synthetic', cache_frozen_features=True, "
        f"result_dir={str(tmp_path)!r}, use_pallas_attention=True, "
        "use_pallas_t5_attention=True)\n"
        "out = train(cfg, device='cpu')\n"
        "assert not out['halted'] and out['steps'] == 2, out\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"('jax', {JAX_PACKAGE!r}) + {OPTIONAL!r} "
        "and sys.modules[m] is not None]\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert (tmp_path / "checkpoints" / "best").is_dir()
    assert (tmp_path / "feature_cache" / "train.img.feat").exists()
    with open(tmp_path / "train.log") as f:
        assert "loss.png not written" in f.read()


JPEG_FIXTURES = ROOT / "tests" / "torch_jpeg"


def _coco_layout(root: pathlib.Path, names: list) -> str:
    """An MSCOCO-layout directory whose train2017/ and val2017/ hold the
    fixture JPEGs ``names`` (each twice in train), one caption each."""
    import json
    import shutil

    d = root / "mscoco2017"
    (d / "annotations").mkdir(parents=True)
    for phase, copies in (("train", 2), ("val", 1)):
        (d / f"{phase}2017").mkdir()
        images, annotations = [], []
        for i, src in enumerate(names * copies):
            name = f"{i:012d}.jpg"
            shutil.copyfile(JPEG_FIXTURES / src, d / f"{phase}2017" / name)
            images.append({"id": i, "file_name": name})
            annotations.append({"id": 100 + i, "image_id": i,
                                "caption": f"a picture number {i % 3}"})
        with open(d / "annotations" / f"captions_{phase}2017.json", "w") as f:
            json.dump({"images": images, "annotations": annotations}, f)
    return str(d)


# Tiny sizes registered under names of this test's own, in both processes.
JPEG_SIZES = (
    "from klab_multimodalmodel_tpu_torch import config as c\n"
    "c.register_t5_size('t5-isolation-jpeg', c.T5Size(d_model=32, d_kv=8, "
    "d_ff=64, num_layers=1, num_decoder_layers=1, num_heads=4, "
    "vocab_size=512, relative_attention_num_buckets=8, "
    "relative_attention_max_distance=16))\n"
    "c.register_swin_size('swin-isolation-jpeg', c.SwinV2Size(image_size=32, "
    "embed_dim=16, depths=(2, 2), num_heads=(2, 4), window_size=4))\n")


def test_jpeg_route_needs_no_pillow(tmp_path):
    """With Pillow (and jax, the JAX package, matplotlib, tensorboard,
    ml_dtypes) blocked: ``load_image_resized`` and
    ``load_image_bytes_resized`` give every fixture JPEG the pixels they give
    with Pillow present (or, for the lossless fixture at a draft scale,
    the same ``ValueError``), a tiny ``train()`` runs over a COCO-layout
    directory of JPEGs, and the ``caption`` CLI captions JPEG files as it
    does with Pillow present; a PNG body raises the ``ValueError`` that
    names PNG."""
    import hashlib
    import io
    import json
    from contextlib import redirect_stdout

    from PIL import Image

    from klab_multimodalmodel_tpu_torch.data.datasets import (
        load_image_bytes_resized, load_image_resized)

    names = sorted(p.name for p in JPEG_FIXTURES.glob("*.jpg"))
    small = [n for n in names if (JPEG_FIXTURES / n).stat().st_size < 30_000]
    data_dir = _coco_layout(tmp_path, small[:4])
    png = tmp_path / "x.png"
    Image.new("RGB", (40, 30), (10, 20, 30)).save(png)
    result_dir = tmp_path / "run"
    images = [str(JPEG_FIXTURES / n) for n in small[:3]]
    argv = ["klab", "caption", *images, "--result_dir", str(result_dir),
            "--device", "cpu"]
    code = (
        "import hashlib, io, json, runpy, sys\n"
        "from contextlib import redirect_stdout\n"
        f"for name in ('jax', 'jaxlib', 'flax', {JAX_PACKAGE!r}) + "
        f"{OPTIONAL!r}:\n"
        "    sys.modules[name] = None\n"
        "from klab_multimodalmodel_tpu_torch.data.datasets import (\n"
        "    load_image_bytes_resized, load_image_resized)\n"
        "out = {'file': {}, 'bytes': {}}\n"
        f"for name in {names!r}:\n"
        f"    path = {str(JPEG_FIXTURES)!r} + '/' + name\n"
        "    try:\n"
        "        out['file'][name] = hashlib.sha256(\n"
        "            load_image_resized(path, 32).tobytes()).hexdigest()\n"
        "    except ValueError as e:\n"
        "        out['file'][name] = str(e)\n"
        "    with open(path, 'rb') as f:\n"
        "        out['bytes'][name] = hashlib.sha256(\n"
        "            load_image_bytes_resized(f.read(), 256).tobytes()"
        ").hexdigest()\n"
        "try:\n"
        f"    load_image_resized({str(png)!r}, 32)\n"
        "except ValueError as e:\n"
        "    out['png'] = str(e)\n"
        + JPEG_SIZES +
        "from klab_multimodalmodel_tpu_torch.train import train\n"
        "cfg = c.Config(image_model_name='swin-isolation-jpeg', "
        "language_model_name='t5-isolation-jpeg', "
        "transformer_model_name='t5-isolation-jpeg', max_source_length=32, "
        "max_target_length=16, generate_max_length=6, batch_size=4, "
        f"num_epochs=1, data_dir={data_dir!r}, "
        f"result_dir={str(result_dir)!r})\n"
        "run = train(cfg, device='cpu')\n"
        "out['steps'] = run['steps']\n"
        f"sys.argv = {argv!r}\n"
        "buf = io.StringIO()\n"
        "with redirect_stdout(buf):\n"
        "    try:\n"
        "        runpy.run_module('klab_multimodalmodel_tpu_torch', "
        "run_name='__main__')\n"
        "    except SystemExit as e:\n"
        "        assert not e.code, e.code\n"
        "out['captions'] = buf.getvalue()\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"('jax', {JAX_PACKAGE!r}) + {OPTIONAL!r} "
        "and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print('RESULT ' + json.dumps(out))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.split("RESULT ", 1)[1])

    def sha(a) -> str:
        return hashlib.sha256(a.tobytes()).hexdigest()

    for name in names:
        path = JPEG_FIXTURES / name
        try:
            want = sha(load_image_resized(str(path), 32))
        except ValueError as e:
            want = str(e)
        assert got["file"][name] == want
        assert got["bytes"][name] == sha(
            load_image_bytes_resized(path.read_bytes(), 256))
    assert got["png"].startswith("cannot decode a PNG image: Pillow is "
                                 "not installed"), got["png"]
    assert got["steps"] == 2
    lines = got["captions"].splitlines()
    assert [ln.split("\t")[0] for ln in lines] == images
    # The same run's captions with Pillow present (the sizes registered
    # here too).
    from klab_multimodalmodel_tpu_torch.cli import caption_main

    exec(JPEG_SIZES, {})
    buf = io.StringIO()
    with redirect_stdout(buf):
        caption_main(argv[2:])
    assert buf.getvalue() == got["captions"]
