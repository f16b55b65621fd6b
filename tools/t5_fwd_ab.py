#!/usr/bin/env python3
"""The bf16 T5 attention forward (``csrc/t5_attention_fwd.cu``) built from
several copies of ``csrc/`` and held against each other on one card: each
build's registers and spills (ptxas) at DP 64 and 128, then its device ms
per launch at phase 4's encoder shape (batch 32, 16 heads, 320 x 320, d_kv
64, a head bias and a key mask), at rate 0.1 and 0, the builds timed in
turns (four rounds, each in another order).

    python3 tools/t5_fwd_ab.py NAME=CSRC_DIR [NAME=CSRC_DIR ...]

A build whose C entry point predates ``q_offset`` is called without it.
Needs a card and the CUDA toolkit; no JAX.
"""

import ctypes
import os
import re
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def build(dirs: dict) -> dict:
    """{name: (ctypes library, takes q_offset)}, the builds run at once."""
    sys.path.insert(0, REPO)
    from klab_multimodalmodel_tpu_torch.ops import cuda_build as cb

    out_dir = tempfile.mkdtemp(prefix="t5_fwd_ab_")
    procs = {}
    for name, d in dirs.items():
        lib = os.path.join(out_dir, f"{name}.so")
        procs[name] = (lib, d, subprocess.Popen(
            [cb.nvcc_path(), *cb.NVCC_FLAGS, "-o", lib,
             os.path.join(d, "t5_attention_fwd.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, d, p) in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log[-3000:]}")
        for e in cb.ptxas_report(log):
            m = re.search(r"tc_kernelILi(\d+)E", e["function"])
            if m and m.group(1) in ("64", "128"):
                print(f"{name}: DP {m.group(1)}: {e['registers']} registers,"
                      f" spills {e['spill_stores']} / {e['spill_loads']} "
                      "bytes", flush=True)
        with open(os.path.join(d, "t5_attention_fwd.cu")) as f:
            takes = "int q_offset" in f.read()
        libs[name] = (ctypes.CDLL(lib), takes)
    return libs


def main() -> int:
    import torch

    if not torch.cuda.is_available() or len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 1
    dirs = dict(a.split("=", 1) for a in sys.argv[1:])
    libs = build(dirs)
    g = torch.Generator(device="cuda").manual_seed(0)
    B, H, Q, K, D = 32, 16, 320, 320, 64
    q, k, v = (torch.randn(B, H, n, D, generator=g, device="cuda")
               .to(torch.bfloat16) for n in (Q, K, K))
    bias = torch.randn(H, Q, K, generator=g, device="cuda")
    kmask = torch.ones(B, K, dtype=torch.int32, device="cuda")
    kmask[:, 94:] = 0
    seed = torch.tensor([1234], dtype=torch.int64, device="cuda")
    out = torch.empty_like(q)
    stats = torch.empty(B, H, Q, 2, device="cuda")
    P, I = ctypes.c_void_p, ctypes.c_int

    def call(name: str, rate: float) -> None:
        lib, takes = libs[name]
        args = [P(t.data_ptr()) for t in (q, k, v, bias, kmask)]
        args += [P(seed.data_ptr()) if rate else None, P(out.data_ptr()),
                 P(stats.data_ptr())]
        args += [I(x) for x in (B, H, Q, K, D, 1, 0)] + ([I(0)] if takes
                                                          else [])
        args += [ctypes.c_double(rate),
                 P(torch.cuda.current_stream().cuda_stream)]
        err = lib.klab_t5_attention_fwd(*args)
        if err:
            raise RuntimeError(f"{name}: launch failed ({err})")

    def ms(name: str, rate: float, n: int = 50) -> float:
        for _ in range(5):
            call(name, rate)
        torch.cuda.synchronize()
        torch.cuda._sleep(50_000_000)  # the queue held: device time only
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(n):
            call(name, rate)
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / n

    names = list(libs)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    for rate in (0.1, 0.0):
        got = {n: [] for n in names}
        for r in range(4):
            order = names[r % len(names):] + names[:r % len(names)]
            for n in (order if r % 2 == 0 else order[::-1]):
                got[n].append(ms(n, rate))
        print(f"rate {rate}, ms a launch at {[B, H, Q, K, D]}: "
              + "; ".join(f"{n} " + ", ".join(f"{x:.4f}" for x in xs)
                          for n, xs in got.items()) + f" [{card}]",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
