"""The port stands alone: it imports no ``jax`` and nothing of the JAX
package, and neither does ``chip_smoke.py``."""

import ast
import pathlib
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
