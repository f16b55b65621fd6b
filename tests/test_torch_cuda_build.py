"""The kernels' build inputs: an installed package ships every file a kernel
source includes, and an edited header gives its kernels a new library (no
stale build is loaded). Nothing here needs ``nvcc`` or a card."""

import pathlib
import re
import shutil
import tomllib

import pytest

from klab_multimodalmodel_tpu_torch.ops import cuda_build

ROOT = pathlib.Path(__file__).resolve().parent.parent
INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _package_data_globs() -> list[str]:
    with open(ROOT / "pyproject.toml", "rb") as f:
        data = tomllib.load(f)["tool"]["setuptools"]["package-data"]
    return data[cuda_build.PACKAGE_DIR.name]


def _shipped() -> set[pathlib.Path]:
    return {p for g in _package_data_globs()
            for p in cuda_build.PACKAGE_DIR.glob(g)}


def test_package_data_ships_every_source_and_include():
    shipped = _shipped()
    sources = [cuda_build.CSRC_DIR / f"{n}.cu" for n in cuda_build.SOURCES]
    for src in sources:
        assert src in shipped, src.name
    for path in sorted(cuda_build.CSRC_DIR.iterdir()):
        for inc in INCLUDE.findall(path.read_text()):
            header = cuda_build.CSRC_DIR / inc
            assert header.exists(), f"{path.name} includes missing {inc}"
            assert header in shipped, (
                f"{path.name} includes {inc}, which no package-data glob "
                f"({_package_data_globs()}) ships")


def test_sources_of_follows_includes():
    names = {n: [p.name for p in cuda_build._sources_of(n)]
             for n in cuda_build.SOURCES}
    assert names["t5_attention_fwd"] == ["t5_attention_fwd.cu", "mma.cuh",
                                         "philox.cuh"]
    assert names["t5_attention_bwd"] == ["t5_attention_bwd.cu", "mma.cuh",
                                         "philox.cuh"]
    assert names["swin_attention_fwd"] == ["swin_attention_fwd.cu"]


@pytest.mark.parametrize("edited,rebuilt", [
    ("philox.cuh", {"t5_attention_fwd", "t5_attention_bwd"}),
    ("mma.cuh", {"t5_attention_fwd", "t5_attention_bwd"}),
    ("swin_attention_fwd.cu", {"swin_attention_fwd"}),
])
def test_library_hash_covers_includes(tmp_path, monkeypatch, edited,
                                      rebuilt):
    csrc = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC_DIR, csrc)
    monkeypatch.setattr(cuda_build, "CSRC_DIR", csrc)
    before = {n: cuda_build._library_path(n) for n in cuda_build.SOURCES}
    with open(csrc / edited, "a") as f:
        f.write("\n// edited\n")
    after = {n: cuda_build._library_path(n) for n in cuda_build.SOURCES}
    assert {n for n in before if before[n] != after[n]} == rebuilt


PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z6kernelILi64EEvv' for 'sm_90a'
ptxas info    : Function properties for _Z6kernelILi64EEvv
    8 bytes stack frame, 4 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 168 registers, used 0 barriers, 384 bytes cmem[0]
ptxas info    : Compiling entry function '_Z5otherv' for 'sm_90a'
ptxas info    : Function properties for _Z5otherv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 32 registers, 368 bytes cmem[0]
"""


def test_ptxas_report_reads_registers_and_spills_per_kernel():
    assert cuda_build.ptxas_report(PTXAS_LOG) == [
        dict(function="_Z6kernelILi64EEvv", registers=168, spill_stores=4,
             spill_loads=8),
        dict(function="_Z5otherv", registers=32, spill_stores=0,
             spill_loads=0),
    ]
    assert cuda_build.ptxas_report("nvcc: no ptxas lines") == []
