"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, loaded with ``ctypes``. The build runs at
first use, from the package's sources only, one ``nvcc`` per source, all
started together, into ``_build/`` beside the package (git-ignored). A
library's file name carries a hash of its source, of every ``csrc/`` header
the source includes (``#include "..."``, followed through headers) and of the
flags, so an edited source or header is rebuilt and a finished build is
reused.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
SOURCES = ("t5_attention_fwd", "t5_attention_bwd", "swin_attention_fwd")
# --split-compile 0: optimize a source's kernels on all CPU cores at once
# (the Swin source instantiates 48).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "--split-compile", "0")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F64 = ctypes.c_double
# C signatures (see each source's extern "C" function).
_SIGNATURES = {
    "t5_attention_fwd": ("klab_t5_attention_fwd",
                         [_P] * 8 + [_I] * 8 + [_F64, _P]),
    "t5_attention_bwd": ("klab_t5_attention_bwd",
                         [_P] * 14 + [_I] * 8 + [_F64, _P]),
    "swin_attention_fwd": ("klab_swin_attention_fwd",
                           [_P] * 7 + [_I] * 7 + [_P]),
}
_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)

_lock = threading.Lock()
_functions: dict[str, ctypes._CFuncPtr] = {}
# nvcc's log of each build in this process (with ptxas's registers, shared
# memory and spills per kernel: ``ptxas_report``), for the chip smoke run.
build_logs: dict[str, str] = {}


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(cuda_home, "bin", "nvcc")] if cuda_home
                 else []) + ["/usr/local/cuda/bin/nvcc"]:
        if os.path.exists(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                           "the CUDA toolkit on the machine with the card")
    return found


def _sources_of(name: str) -> list[Path]:
    """The ``.cu`` file of kernel ``name`` and every ``csrc/`` header it
    includes, directly or through another header, in a fixed order."""
    seen: list[Path] = []
    todo = [CSRC_DIR / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        for inc in _INCLUDE.findall(path.read_bytes()):
            header = CSRC_DIR / inc.decode()
            if header.exists():
                todo.append(header)
    return seen


def _library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources_of(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all() -> None:
    """Compile every source whose library is missing: one ``nvcc`` each,
    all running at once. Raises with the compiler's output on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    jobs = []
    for name in SOURCES:
        target = _library_path(name)
        if target.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((name, target, tmp, proc))
    failures = []
    for name, target, tmp, proc in jobs:
        log, _ = proc.communicate()
        build_logs[name] = log
        if proc.returncode != 0:
            os.unlink(tmp)
            failures.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, target)  # atomic: other processes see whole files
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))


_PTXAS_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_PTXAS_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_PTXAS_REGS = re.compile(r"Used (\d+) registers")


def ptxas_report(log: str) -> list[dict]:
    """Per kernel entry function of an ``nvcc -Xptxas -v`` log: its
    (mangled) name, registers per thread and spill bytes, in log order."""
    out: list[dict] = []
    for line in log.splitlines():
        m = _PTXAS_ENTRY.search(line)
        if m:
            out.append(dict(function=m.group(1), registers=None,
                            spill_stores=0, spill_loads=0))
            continue
        if not out:
            continue
        m = _PTXAS_SPILL.search(line)
        if m:
            out[-1]["spill_stores"] = int(m.group(1))
            out[-1]["spill_loads"] = int(m.group(2))
        m = _PTXAS_REGS.search(line)
        if m:
            out[-1]["registers"] = int(m.group(1))
    return out


def kernel_function(name: str):
    """The ctypes function of kernel ``name``, building it first if needed."""
    with _lock:
        fn = _functions.get(name)
        if fn is None:
            path = _library_path(name)
            if not path.exists():
                build_all()
            symbol, argtypes = _SIGNATURES[name]
            fn = getattr(ctypes.CDLL(str(path)), symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _functions[name] = fn
        return fn
