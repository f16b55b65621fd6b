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
