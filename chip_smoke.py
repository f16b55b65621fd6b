#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it fails:

1. Record the card (``nvidia-smi`` name and power limit) and build the three
   CUDA kernels from ``klab_multimodalmodel_tpu_torch/csrc``, one ``nvcc``
   per source, all at once; print ptxas's registers and spills of every
   kernel instantiation.
2. Hold each kernel against its plain PyTorch version at the shapes of both
   main paths, and time kernel, plain version and the library yardstick
   (``F.scaled_dot_product_attention``, forward or forward+backward) with
   CUDA events, beside the least time the card could take. Times are device
   times: the host enqueues each timed loop behind a device-side sleep (see
   ``time_both``), and the host's time per call of the kernel's wrapper
   and of SDPA is printed beside them at the forward kernels' shapes:
   - T5 forward: captioning shapes at rate 0 (fp32, bf16); training shapes
     (batch 32, bf16) at rate 0.1 against the plain version under the same
     Philox mask, once more with uniform probabilities (any keep bit that
     differed would show), and the keep fraction over 52 M probabilities;
   - T5 backward: the three training shapes (encoder self 320x320 with
     dBias, decoder self 128x128 with relpos+causal bias and dBias, cross
     128x320 with a key mask) at rate 0.1 in fp32 and bf16 against the plain
     backward, dq, dk, dv and dBias bitwise equal across two runs, and the
     time with dBias against without it (the dS scratch and its reduction);
   - at the training shapes, both T5 kernels also timed without dropout and
     without the head bias: what each input costs them;
   - Swin forward: every stage shape with the fp32 and the bf16 softmax
     chain, at captioning (fp32) and training (bf16, batch 32) shapes; then
     swinv2-large's windows (N = 36 and 144) and launches whose windows do
     not split evenly into the kernel's groups (see
     ``swin_extra_cases``), in both input dtypes and both chains. Beside
     each timed Swin shape, a yardstick for the attention part only: SDPA
     on q and k normalized and scaled outside the timed call, with the
     bias (and mask) as its float mask. No single PyTorch call computes
     the whole function, so it is no ``library_ms``.
   Each redesigned kernel's time per request or per step is printed beside
   that of the kernel it replaced (``OLD_PATH_MS``, as ``PERF.md`` records
   it) and beside SDPA's or the yardstick.
3. Caption at full width: SwinV2-base + t5-large text tower + t5-large
   transformer (~1.16 B parameters, fp32, seeded random weights), both
   kernel flags on, three batch-8 requests through ``Captioner``; checks the
   launch counts of every request (24 Swin, 48 T5), the token layout, a
   finite encoder output, and the encoder output against the same weights
   run without the kernels.
4. Train at full width: the reference caption recipe's ``Config`` defaults
   (compute bf16, fp32 parameters, Adam lr 1e-3, frozen towers, both kernel
   flags on), batch 32, one warm-up step and five timed steps with dropout
   on one fixed batch of seeded images, the COCO prompt and seeded captions.
   Checks the launches of every step (T5 forward 96, 72 of them at rate
   0.1; T5 backward 72, 48 with dBias; Swin 24), finite and falling losses,
   frozen towers bitwise unchanged, both relative-position tables moved;
   then, at batch 8 with dropout off, the loss and every trainable
   gradient with the kernels against the same weights without them, and in
   bf16 compute against the forward kernel followed by the plain backward
   (the backward kernel's roundings), with readings that split the bf16
   gap to the path without kernels beside it (see ``TOL_TRAIN_GRAD``).
   Prints step time, images/s, peak memory and one profiled step (with the
   optimizer's device time).
5. The ``train_with_swin`` recipe and the training options:
   a. the SwinV2 tower trainable (``image_model_train``), both kernel flags
      on, otherwise phase 4's set-up: one warm-up and five timed steps.
      Checks the launches of every step (phase 4's: the Swin kernel's 24
      forwards; its backward is a recompute in plain PyTorch), finite and
      falling losses, the text tower bitwise unchanged, every SwinV2 tensor
      moved (each logit scale and the position-bias MLP included), and the
      trainable count (t5-large + projection + the SwinV2 tower). Prints
      step time, images/s, peak memory, the profiled step's busy share and
      the Swin backward's device time in it.
   b. batch 8, dropout off, on 5a's weights: the loss and every SwinV2
      gradient with the Swin kernel against the same path without it,
      checked at phase 4's tolerances in fp32 compute, printed beside them
      in bf16 compute, with a reading that splits the bf16 gap (see
      ``swin_kernel_vs_none``).
   c. three timed steps each of the frozen towers and Adam's first moment
      stored in bf16, of Adafactor, and of ``remat`` 'full' and
      'dots_saveable' (frozen towers, kernel flags on, batch 32), in one
      table beside phase 4's step: step ms, device busy ms, the optimizer's
      device time and share, peak memory. Under remat each step launches
      the T5 forward 96 + 72 times (the recompute).
6. The training loop: ``train(config)`` at full width (the Config
   defaults, both kernel flags on, batch 32, 2 epochs) on the synthetic
   dataset (64 rows of 256 px, the COCO prompt; 2 updates and 2 validation
   batches an epoch), four runs in a temporary result directory: A
   uncached; C with ``cache_frozen_features`` (epoch 1 fills, epoch 2 trains
   from the cache); B1 as C halting after update 3; B2 the same command
   again, which resumes from ``step_3``. First one step twice from the same
   state and generator (the determinism reading). Checks the launches of
   every step and validation batch (full step 96 / 72 / 24 T5 forward /
   backward / Swin, cached step 72 / 72 / 0, full val batch 96 / 0 / 24,
   cached val batch 72 / 0 / 0), C's losses against A's and B2's losses,
   steps, min_val_loss and trainable parameters against C's (bitwise, or
   within the determinism reading's gap), the checkpoints, sidecars, cache
   files and ``metrics.jsonl``. Prints each step kind's device span (CUDA
   events, nothing synchronized inside the loop) and peak memory, one
   profiled full and one profiled cached step, images/s per epoch, the
   host time the deferred fill blocks, and each save's size, stall and
   background write; the free disk before it.
7. Prints the ``{"kernels": [...]}`` line (with each kernel's launches in
   one phase-5a step and in phase 6's full and cached steps), then
   ``{"ok": true, ...}`` as the last line.

It needs one card and exits non-zero, printing no result, where
``torch.cuda.is_available()`` is false. Full results also go to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
CSRC = "klab_multimodalmodel_tpu_torch/csrc/"
TPU_KERNELS = "klab_multimodalmodel_tpu/ops/fused_attention.py"
KERNELS = {  # name: (source, the TPU kernel it replaces)
    # Both forwards replace modes of the one forward Pallas kernel.
    "t5_attention_fwd": (CSRC + "t5_attention_fwd.cu", TPU_KERNELS + ":109"),
    "t5_attention_bwd": (CSRC + "t5_attention_bwd.cu", TPU_KERNELS + ":179"),
    "swin_attention_fwd": (CSRC + "swin_attention_fwd.cu",
                           TPU_KERNELS + ":109"),
}

# Per-path times of the kernels that this tree's kernels replaced, as
# PERF.md section 6 records them (chip_smoke.py on NVIDIA H100 80GB HBM3,
# 700.00 W), printed beside this run's: (kernel, path): (ms, what, source).
OLD_PATH_MS = {
    ("t5_attention_fwd", "training"): (
        160.49, "scalar kernel", "PERF.md section 6, row 1"),
    ("t5_attention_bwd", "training"): (
        300.07, "scalar kernels", "PERF.md section 6, row 3"),
    ("t5_attention_fwd", "captioning"): (
        2.03, "scalar fp32 kernel", "PERF.md section 6, row 1f"),
    ("swin_attention_fwd", "training"): (
        6.32, "block per (window, head)", "PERF.md section 6, row 2"),
    ("swin_attention_fwd", "captioning"): (
        1.742, "block per (window, head)", "PERF.md section 6, row 2f"),
}

# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W): memory,
# fp32 outside the tensor cores (fp32 inputs), bf16 tensor cores (bf16).
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOP_PER_S = {"float32": 67e12, "bfloat16": 989e12}

# Kernel vs plain version: summation order; bf16 also rounds q/k, the
# probabilities and the output (one bf16 ulp of a result near 2-4 is 0.016).
TOL_FP32 = dict(rtol=0.0, atol=1e-4)
TOL_BF16 = dict(rtol=2e-2, atol=2e-2)
# Gradients, largest error over largest value: dS and the dropped
# probabilities are rounded to bf16 before their products in bf16; the bias
# gradient sums the fp32 dS in both versions.
TOL_GRAD = {"float32": 1e-4, "bfloat16": 2e-2, "dbias": 1e-4}
# Swin with a bf16 softmax chain: a logit can round one bf16 ulp apart (fp32
# dot products summed in another order), which moves one probability by up
# to ~28 % at logits in [32, 64). Such flips are rare: at most 1e-4 of the
# outputs may fall outside the bf16 tolerance above, and the mean error
# stays under 1e-3.
TOL_SWIN_BF16_CHAIN = dict(outside=1e-4, mean=1e-3)
# Keep fraction of the dropout at rate 0.1.
TOL_KEEP = 1e-3
# Encoder output with kernels vs without, relative to its largest value:
# fp32 summation order compounded over 24 + 24 + 24 layers.
TOL_ENCODER_REL = 1e-3
# Training at batch 8, dropout off, on the same weights: the loss within
# 1e-2 relative; every trainable tensor's gradient at cosine >= 0.99 and a
# norm within 2 %, all of them together at cosine >= 0.999 (TOL_TRAIN_GRAD).
# That holds the kernels against the path without them in fp32 compute, where
# the two differ by summation order only, and in bf16 compute against the
# forward kernel followed by the plain backward, which rounds as the backward
# kernel does. The path without kernels rounds otherwise in bf16: its
# autograd rounds dP to bf16 (the gradient of the probabilities' cast) before
# dS = P (dP - sum dP P) subtracts two near-equal numbers, where the backward
# kernel, as the TPU kernel, keeps dP in fp32; and its forwards round
# differently from the kernels'. Single deep-decoder q/k gradients move by a
# few % under either. Against that path every tensor is held at cosine >= 0.9
# and a norm within 15 % (TOL_TRAIN_GRAD_BF16_VS_NONE); the readings that
# split the gap between the two causes are printed beside it.
TOL_TRAIN_LOSS_REL = 1e-2
TOL_TRAIN_GRAD = dict(cosine=0.99, norm=0.02, total=0.999)
TOL_TRAIN_GRAD_BF16_VS_NONE = dict(cosine=0.9, norm=0.15, total=0.999)

BATCH, REQUESTS, SEED = 8, 3, 0
TRAIN_BATCH, CMP_BATCH, STEPS, RATE = 32, 8, 5, 0.1
T5_H, T5_D, SWIN_N, SWIN_D = 16, 64, 64, 32
T5_LAYERS = 24
SRC_LEN, TGT_LEN, IMG_TOKENS = 256, 128, 64
ENC_LEN = IMG_TOKENS + SRC_LEN


def build_report() -> list[dict]:
    """ptxas's registers and spills of every kernel instantiation that this
    process built, printed one line each (names demangled by ``c++filt``
    where the toolkit's machine has it)."""
    from klab_multimodalmodel_tpu_torch.ops import cuda_build

    rows = [dict(source=name, **r)
            for name, log in cuda_build.build_logs.items()
            for r in cuda_build.ptxas_report(log)]
    try:
        names = subprocess.run(
            ["c++filt"], input="\n".join(r["function"] for r in rows),
            capture_output=True, text=True, timeout=60,
            check=True).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        names = []
    if len(names) != len(rows):
        names = [r["function"] for r in rows]
    for r, name in zip(rows, names):
        r["kernel"] = name.replace("(anonymous namespace)::", "").split("(")[0]
        print(f"  {r['source']}: {r['kernel']}: {r['registers']} registers, "
              f"spill stores {r['spill_stores']} B, spill loads "
              f"{r['spill_loads']} B")
    return rows


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    check(bool(out), "nvidia-smi printed no card")
    return out.splitlines()[0]


# Clock cycles of the device-side sleep that holds the queue while the host
# enqueues a timed loop: ~25 ms at the H100's 1.98 GHz, longer than any
# loop's enqueue in phase 2.
HOLD_CYCLES = 50_000_000


def time_both(fn, iters: int = 50, warmup: int = 5) -> tuple[float, float]:
    """(device ms, host ms) per call of ``fn()``: CUDA events around
    ``iters`` back-to-back calls that the host enqueues behind a device-side
    sleep (``torch.cuda._sleep``), so the device runs them from its queue
    without waiting for the host, and the host clock over the enqueue. A
    small kernel's wrapper can take longer on the host than the kernel on
    the card; back-to-back events would then time the host. Inputs stay warm
    in L2, as they are when the preceding projection has just written
    them."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(HOLD_CYCLES)
    t0 = time.perf_counter()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    host = (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, host


def time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of ``fn()`` in ms (see ``time_both``)."""
    return time_both(fn, iters, warmup)[0]


def host_ms(fn, runs: int = 3) -> float:
    """Median host-clock time of ``fn()`` in ms, each run ending in a
    device synchronize (a request-level time)."""
    import torch

    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2]


def bound_ms(nbytes: float, flops: float, dtype: str) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOP_PER_S[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def rel_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max() / b.float().abs().max())


def dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def sdpa_backends(fn) -> list[str]:
    """The ATen attention ops one call of ``fn`` ran (the SDPA backend)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return sorted({e.key for e in prof.key_averages()
                   if e.key.startswith("aten::_scaled_dot_product")
                   or e.key.startswith("aten::_efficient_attention")
                   or e.key.startswith("aten::_flash_attention")})


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class T5Shape:
    name: str
    path: str          # "captioning" (per request) or "training" (per step)
    B: int
    Q: int
    K: int
    bias: bool         # a learned head bias (with dBias in the backward)
    mask: int          # keys masked at the end of every row, -1 for none
    rate: float
    per_path: int      # launches in one request or one training step
    causal: bool = False


def t5_shapes() -> list[T5Shape]:
    # Captioning: text tower at the COCO prompt's 30 ids bucketed to 32 (2
    # pad keys masked), main encoder at 64 image tokens + those 32.
    # Training, batch 32: text tower at 256 (the prompt padded: 226 pad
    # keys), main encoder at 320 (the same pads), decoder self-attention at
    # 128 with relpos + causal bias and no key mask, cross-attention 128 x
    # 320 with the encoder's key mask and no bias.
    pad = SRC_LEN - 30
    return [
        T5Shape("text", "captioning", BATCH, 32, 32, True, 2, 0.0, 24),
        T5Shape("encoder", "captioning", BATCH, 96, 96, True, 2, 0.0, 24),
        T5Shape("text", "training", TRAIN_BATCH, SRC_LEN, SRC_LEN, True, pad,
                0.0, T5_LAYERS),
        T5Shape("encoder", "training", TRAIN_BATCH, ENC_LEN, ENC_LEN, True,
                pad, RATE, T5_LAYERS),
        T5Shape("decoder", "training", TRAIN_BATCH, TGT_LEN, TGT_LEN, True,
                -1, RATE, T5_LAYERS, causal=True),
        T5Shape("cross", "training", TRAIN_BATCH, TGT_LEN, ENC_LEN, False,
                pad, RATE, T5_LAYERS),
    ]


def t5_inputs(sh: T5Shape, dtype, gen):
    import torch

    dev = "cuda"
    q = torch.randn(sh.B, T5_H, sh.Q, T5_D, generator=gen, device=dev)
    k, v, do = (torch.randn(sh.B, T5_H, n, T5_D, generator=gen, device=dev)
                for n in (sh.K, sh.K, sh.Q))
    q, k, v, do = (t.to(dtype) for t in (q, k, v, do))
    bias = None
    if sh.bias:
        bias = torch.randn(T5_H, sh.Q, sh.K, generator=gen, device=dev)
        if sh.causal:
            i = torch.arange(sh.Q, device=dev)
            bias = bias + torch.where(i[:, None] >= i[None, :], 0.0, -1e9)
    kmask = None
    if sh.mask >= 0:
        kmask = torch.ones(sh.B, sh.K, dtype=torch.int32, device=dev)
        kmask[:, sh.K - sh.mask:] = 0
    return q, k, v, do, bias, kmask


def sdpa_mask(bias, kmask, dtype):
    """The additive float mask SDPA takes for (bias, key mask)."""
    import torch

    parts = []
    if bias is not None:
        parts.append(bias[None])
    if kmask is not None:
        parts.append(torch.where(kmask[:, None, None, :] > 0, 0.0, -1e9))
    if not parts:
        return None
    out = parts[0] if len(parts) == 1 else parts[0] + parts[1]
    return out.to(dtype)


def io_bytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def check_t5_fwd(gen, card: str) -> dict:
    import torch
    import torch.nn.functional as F

    from klab_multimodalmodel_tpu_torch.ops import (draw_seed, t5_attention,
                                                    t5_attention_fwd,
                                                    t5_attention_plain)
    shapes, errs, errs16 = [], [], []
    for sh in t5_shapes():
        seed = draw_seed(gen) if sh.rate else None
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, _, bias, kmask = t5_inputs(sh, dtype, gen)
            got = t5_attention(q, k, v, bias, kmask, sh.rate, seed)
            torch.cuda.synchronize()
            want = t5_attention_plain(q, k, v, bias, kmask, sh.rate, seed)
            err = max_err(got, want)
            tol = TOL_FP32 if dtype == torch.float32 else TOL_BF16
            check(torch.allclose(got.float(), want.float(), **tol),
                  f"t5 fwd {sh.name} {sh.path} {dtype}: max abs err {err}")
            (errs if dtype == torch.float32 else errs16).append(err)
            if sh.rate:
                # Uniform probabilities: each key weighs 1/(0.9 K), so one
                # keep bit that differed from the plain version's would move
                # an output by ~|v|/(0.9 K), far above the tolerance.
                z = torch.zeros_like(q)
                got = t5_attention(z, k, v, None, None, sh.rate, seed)
                want = t5_attention_plain(z, k, v, None, None, sh.rate, seed)
                check(torch.allclose(got.float(), want.float(), **tol),
                      f"t5 fwd {sh.name} uniform P {dtype}: keep bits "
                      f"differ (max abs err {max_err(got, want)})")
        # Time in the path's dtype: fp32 for captioning, bf16 for training.
        dtype = torch.float32 if sh.path == "captioning" else torch.bfloat16
        q, k, v, _, bias, kmask = t5_inputs(sh, dtype, gen)
        # Training calls that need a gradient also write the row stats.
        stats = sh.path == "training" and sh.name != "text"
        iters = 20 if sh.path == "training" else 50
        ms, host = time_both(lambda: t5_attention_fwd(
            q, k, v, bias, kmask, sh.rate, seed, stats), iters)
        plain = time_ms(lambda: t5_attention_plain(q, k, v, bias, kmask,
                                                   sh.rate, seed), iters)
        # What the kernel's inputs cost it at the training shapes: the same
        # call without dropout and without the head bias.
        costs = {}
        if sh.path == "training" and sh.rate:
            costs["rate0_ms"] = time_ms(lambda: t5_attention_fwd(
                q, k, v, bias, kmask, 0.0, None, stats), iters)
        if sh.path == "training" and bias is not None:
            costs["no_bias_ms"] = time_ms(lambda: t5_attention_fwd(
                q, k, v, None, kmask, sh.rate, seed, stats), iters)
        mask = sdpa_mask(bias, kmask, dtype)
        if mask is not None:
            mask = mask.expand(sh.B, T5_H, sh.Q, sh.K).contiguous()

        def sdpa():
            return F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, dropout_p=sh.rate, scale=1.0)
        lib, lib_host = time_both(sdpa, iters)
        nbytes = (io_bytes(q, k, v, q) + io_bytes(bias, kmask)
                  + (8 * sh.B * T5_H * sh.Q if stats else 0))
        flops = 4 * sh.B * T5_H * sh.Q * sh.K * T5_D
        b, by = bound_ms(nbytes, flops, dtype_name(dtype))
        shapes.append(dict(
            name=sh.name, path=sh.path, shape=[sh.B, T5_H, sh.Q, sh.K, T5_D],
            dtype=dtype_name(dtype), rate=sh.rate, per_path=sh.per_path,
            ms=ms, plain_ms=plain, library_ms=lib, library=sdpa_backends(sdpa),
            bound_ms=b, bound_by=by, bytes=nbytes, flops=flops,
            host_ms=host, library_host_ms=lib_host, **costs))
        print(f"t5 fwd {sh.path} {sh.name} B={sh.B} Q={sh.Q} K={sh.K} "
              f"{dtype_name(dtype)} rate={sh.rate}: kernel {ms:.4f} ms, plain "
              f"{plain:.4f} ms, sdpa {lib:.4f} ms, bound {b:.4f} ms ({by}) "
              f"[{card}]" + "".join(f", {k.removesuffix('_ms')} {v:.4f} ms"
                                    for k, v in costs.items())
              + f"; host per call: wrapper {host:.4f} ms, sdpa "
              f"{lib_host:.4f} ms")

    # Keep fraction over 32*16*320*320 = 52.4 M probabilities: q = 0 and
    # v = 1 make every output (kept keys)/(0.9 K).
    z = torch.zeros(TRAIN_BATCH, T5_H, ENC_LEN, T5_D, device="cuda")
    out = t5_attention(z, z, torch.ones_like(z), None, None, RATE,
                       draw_seed(gen))
    keep = float(out[..., 0].double().mean() * (1 - RATE))
    print(f"dropout keep fraction over {z[..., 0].numel() * ENC_LEN} "
          f"probabilities: {keep:.6f} (0.9 +- {TOL_KEEP})")
    check(abs(keep - (1 - RATE)) <= TOL_KEEP, f"keep fraction {keep}")
    return dict(name="t5_attention_fwd", mode="plain (T5), rates 0 and 0.1",
                max_abs_err=max(errs), max_abs_err_bf16=max(errs16),
                keep_fraction=keep, shapes=shapes)


def check_t5_bwd(gen, card: str) -> dict:
    import torch
    import torch.nn.functional as F

    from klab_multimodalmodel_tpu_torch.ops import (draw_seed,
                                                    t5_attention_bwd,
                                                    t5_attention_bwd_plain,
                                                    t5_attention_fwd)
    shapes, errs, rels16 = [], [], []
    for sh in t5_shapes():
        if sh.path != "training" or sh.name == "text":
            continue  # the frozen text tower takes no backward
        seed = draw_seed(gen)
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, do, bias, kmask = t5_inputs(sh, dtype, gen)
            _, stats = t5_attention_fwd(q, k, v, bias, kmask, RATE, seed,
                                        True)
            got = t5_attention_bwd(q, k, v, do, bias, kmask, RATE, seed,
                                   stats, sh.bias)
            torch.cuda.synchronize()
            want = t5_attention_bwd_plain(q, k, v, do, bias, kmask, RATE,
                                          seed, sh.bias)
            for name, g, w in zip(("dq", "dk", "dv", "dbias"), got, want):
                if w is None:
                    check(g is None, f"{name} without a bias")
                    continue
                tol = TOL_GRAD["dbias" if name == "dbias"
                               else dtype_name(dtype)]
                r = rel_err(g, w)
                check(g.dtype == w.dtype and r <= tol,
                      f"t5 bwd {sh.name} {dtype} {name}: rel err {r}")
                if dtype == torch.float32:
                    errs.append(max_err(g, w))
                else:
                    rels16.append(r)
            if sh.bias and dtype == torch.bfloat16:
                again = t5_attention_bwd(q, k, v, do, bias, kmask, RATE,
                                         seed, stats, True)
                check(all(torch.equal(a, b) for a, b in zip(got, again)),
                      f"t5 bwd {sh.name}: two runs differ (dq, dk, dv and "
                      "dBias must be bitwise reproducible)")
        # Time in bf16, as training runs it.
        dtype = torch.bfloat16
        q, k, v, do, bias, kmask = t5_inputs(sh, dtype, gen)
        _, stats = t5_attention_fwd(q, k, v, bias, kmask, RATE, seed, True)
        ms = time_ms(lambda: t5_attention_bwd(q, k, v, do, bias, kmask, RATE,
                                              seed, stats, sh.bias), 10, 2)
        # With dBias the dS scratch (B, H, Q, K) fp32 is written once and
        # read once by the reduction over b.
        no_dbias_ms = scratch_bytes = no_bias_ms = None
        if sh.bias:
            no_dbias_ms = time_ms(lambda: t5_attention_bwd(
                q, k, v, do, bias, kmask, RATE, seed, stats, False), 10, 2)
            scratch_bytes = 2 * 4 * sh.B * T5_H * sh.Q * sh.K
        if bias is not None:
            no_bias_ms = time_ms(lambda: t5_attention_bwd(
                q, k, v, do, None, kmask, RATE, seed, stats, False), 10, 2)
        rate0_ms = time_ms(lambda: t5_attention_bwd(
            q, k, v, do, bias, kmask, 0.0, None, stats, sh.bias), 10, 2)
        plain = time_ms(lambda: t5_attention_bwd_plain(
            q, k, v, do, bias, kmask, RATE, seed, sh.bias), 10, 2)
        # Library: SDPA forward + backward with the same dropout rate and a
        # float mask that requires grad where the bias does, minus its
        # forward.
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        bias_leaf = (bias.detach().requires_grad_() if bias is not None
                     else None)

        def sdpa_fwd():
            mask = sdpa_mask(bias_leaf, kmask, dtype)
            return F.scaled_dot_product_attention(
                *leaves, attn_mask=mask, dropout_p=RATE, scale=1.0)

        def sdpa_fwd_bwd():
            inputs = leaves + ([bias_leaf] if bias_leaf is not None else [])
            return torch.autograd.grad(sdpa_fwd(), inputs, do)

        lib_fwd = time_ms(sdpa_fwd, 10, 2)
        lib = time_ms(sdpa_fwd_bwd, 10, 2) - lib_fwd
        # Reads q, k, v, dO, the bias, the key mask and the row stats once;
        # writes dq, dk, dv (the sizes of q, k, v) and dBias (the bias's).
        nbytes = (io_bytes(q, k, v, do) + io_bytes(q, k, v)
                  + io_bytes(bias, kmask, stats)
                  + (io_bytes(bias) if sh.bias else 0))
        # The gradients' four products plus the logits again (the inputs do
        # not hold P): 10 B H Q K D.
        flops = 10 * sh.B * T5_H * sh.Q * sh.K * T5_D
        b, by = bound_ms(nbytes, flops, "bfloat16")
        shapes.append(dict(
            name=sh.name, path="training", shape=[sh.B, T5_H, sh.Q, sh.K,
                                                  T5_D],
            dtype="bfloat16", rate=RATE, dbias=sh.bias, per_path=sh.per_path,
            ms=ms, plain_ms=plain, library_ms=lib,
            library=sdpa_backends(sdpa_fwd_bwd), bound_ms=b, bound_by=by,
            bytes=nbytes, flops=flops, no_dbias_ms=no_dbias_ms,
            dbias_scratch_bytes=scratch_bytes, rate0_ms=rate0_ms,
            no_bias_ms=no_bias_ms))
        print(f"t5 bwd training {sh.name} B={sh.B} Q={sh.Q} K={sh.K} bf16 "
              f"dbias={sh.bias}: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
              f"sdpa bwd {lib:.4f} ms ({shapes[-1]['library']}), bound "
              f"{b:.4f} ms ({by}) [{card}]")
        print(f"  without dropout {rate0_ms:.4f} ms" + (
            f", without the bias {no_bias_ms:.4f} ms"
            if no_bias_ms is not None else "") + f" [{card}]")
        if sh.bias:
            print(f"  without dBias {no_dbias_ms:.4f} ms: the dS scratch "
                  f"({scratch_bytes} bytes written and read) and its "
                  f"reduction cost {ms - no_dbias_ms:.4f} ms [{card}]")
    return dict(name="t5_attention_bwd", mode="T5, rate 0.1, dBias",
                max_abs_err=max(errs), max_rel_err_bf16=max(rels16),
                shapes=shapes)


def swin_stage_cases(batch: int):
    """(stage, windows B*nW, heads, nW of the shifted mask, unshifted
    blocks, shifted blocks, feature side) per stage of SwinV2-base at
    256 px."""
    from klab_multimodalmodel_tpu_torch.config import SwinV2Size

    size = SwinV2Size()
    side = size.image_size // size.patch_size
    out = []
    for si, (depth, heads) in enumerate(zip(size.depths, size.num_heads)):
        nW = (side // size.window_size) ** 2 if side > size.window_size else 1
        shifted = depth // 2 if side > size.window_size else 0
        out.append((si, batch * nW, heads, nW, depth - shifted, shifted,
                    side))
        side //= 2
    return out


def swin_extra_cases():
    """(case, windows Bn, heads, window side, feature side) beyond
    swinv2-base's stages: swinv2-large's windows at a small batch, and
    launches whose windows do not split evenly into the kernel's groups
    (with Bn H >= 2048 it puts G = 2 windows in a block, so an odd number
    of windows per mask position leaves a last block of one)."""
    return [("N=36 (window 6, nW=4)", 32, 4, 6, 12),
            ("N=144 (window 12, nW=4)", 32, 4, 12, 24),
            ("33 windows a mask position, G=2", 132, 16, 8, 16),
            ("65 windows unmasked, G=2", 65, 32, 8, 8)]


def swin_tables(gen, H: int, w: int, side: int):
    """A per-head logit scale, the position bias (H, N, N) and, where the
    feature map is larger than the window, the shifted-window mask."""
    import torch

    from klab_multimodalmodel_tpu_torch.models.swinv2 import (
        shifted_window_mask)
    scale = (torch.log(torch.tensor(10.0, device="cuda"))
             + 0.5 * torch.randn(H, generator=gen, device="cuda"))
    bias = 16 * torch.sigmoid(torch.randn(H, w * w, w * w, generator=gen,
                                          device="cuda"))
    wmask = None
    if side > w:
        wmask = torch.tensor(shifted_window_mask(side, side, w, w // 2),
                             device="cuda")
    return scale, bias, wmask


def chain_errors(got, want) -> dict:
    """Against the plain version with a bf16 softmax chain: the share of
    outputs outside the bf16 tolerance, the mean and the largest error."""
    e = (got.float() - want.float()).abs()
    out = float((e > TOL_BF16["atol"] + TOL_BF16["rtol"]
                 * want.float().abs()).float().mean())
    return dict(max=float(e.max()), mean=float(e.mean()), outside=out)


def chain_ok(c: dict) -> bool:
    return (c["outside"] <= TOL_SWIN_BF16_CHAIN["outside"]
            and c["mean"] <= TOL_SWIN_BF16_CHAIN["mean"])


def swin_yardstick(q, k, v, scale, bias, wmask):
    """SDPA on the attention part alone, as a yardstick: q and k
    L2-normalized and q scaled by its head's clamped logit scale outside
    the timed call, the bias (plus the window mask) as the float mask, in
    the input dtype. The port never calls it."""
    import torch
    import torch.nn.functional as F

    from klab_multimodalmodel_tpu_torch.ops.fused_attention import (
        LOG_MAX_SCALE)

    def l2n(x):
        x32 = x.float()
        return x32 * torch.rsqrt((x32 * x32).sum(-1, keepdim=True) + 1e-24)
    s = torch.exp(torch.clamp(scale, max=LOG_MAX_SCALE))
    qs = (l2n(q) * s[None, :, None, None]).to(q.dtype)
    kn = l2n(k).to(k.dtype)
    mask = bias[None]
    if wmask is not None:
        mask = mask + wmask.repeat(q.shape[0] // wmask.shape[0], 1,
                                   1)[:, None]
    mask = mask.to(q.dtype)
    return lambda: F.scaled_dot_product_attention(qs, kn, v, attn_mask=mask,
                                                  scale=1.0)


def check_swin_extra(gen) -> list[dict]:
    """``swin_extra_cases`` in both input dtypes and both chains against the
    plain version, at the tolerances of the stage shapes."""
    import torch

    from klab_multimodalmodel_tpu_torch.ops import (swin_attention,
                                                    swin_attention_plain)
    out = []
    for case, Bn, H, w, side in swin_extra_cases():
        scale, bias, wmask = swin_tables(gen, H, w, side)
        for wm in [None] + ([wmask] if wmask is not None else []):
            for dt in (torch.float32, torch.bfloat16):
                q, k, v = (torch.randn(Bn, H, w * w, SWIN_D, generator=gen,
                                       device="cuda").to(dt)
                           for _ in range(3))
                for sm in (torch.float32, torch.bfloat16):
                    got = swin_attention(q, k, v, scale, bias, wm, sm)
                    torch.cuda.synchronize()
                    want = swin_attention_plain(q, k, v, scale, bias, wm, sm)
                    what = (f"swin {case} masked={wm is not None} {dt} "
                            f"chain {dtype_name(sm)}")
                    if sm == torch.float32:
                        tol = TOL_FP32 if dt == torch.float32 else TOL_BF16
                        err = dict(max=max_err(got, want))
                        check(torch.allclose(got.float(), want.float(),
                                             **tol),
                              f"{what}: max abs err {err['max']}")
                    else:
                        err = chain_errors(got, want)
                        check(chain_ok(err), f"{what}: {err}")
                    out.append(dict(case=case, shape=[Bn, H, w * w, SWIN_D],
                                    masked=wm is not None,
                                    dtype=dtype_name(dt),
                                    chain=dtype_name(sm), **err))
    print(f"swin beyond swinv2-base ({len(out)} checks: N=36, N=144, "
          f"ragged groups; both dtypes and chains): worst fp32-chain max abs "
          f"err {max(c['max'] for c in out if c['chain'] == 'float32'):.2e},"
          f" worst bf16-chain share outside "
          f"{max(c['outside'] for c in out if 'outside' in c):.2e}")
    return out


def check_swin(gen, card: str) -> dict:
    import torch

    from klab_multimodalmodel_tpu_torch.ops import (swin_attention,
                                                    swin_attention_plain)
    shapes, errs, errs16, chain = [], [], [], []
    for path, batch, dtype in (("captioning", BATCH, torch.float32),
                               ("training", TRAIN_BATCH, torch.bfloat16)):
        for si, Bn, H, nW, n_plain, n_shift, side in swin_stage_cases(batch):
            w = int(SWIN_N ** 0.5)
            scale, bias, wmask = swin_tables(gen, H, w, side)
            for masked, count in ((False, n_plain), (True, n_shift)):
                if count == 0:
                    continue
                wm = wmask if masked else None
                for dt in (torch.bfloat16, torch.float32):
                    q, k, v = (torch.randn(Bn, H, SWIN_N, SWIN_D,
                                           generator=gen,
                                           device="cuda").to(dt)
                               for _ in range(3))
                    got = swin_attention(q, k, v, scale, bias, wm)
                    torch.cuda.synchronize()
                    want = swin_attention_plain(q, k, v, scale, bias, wm)
                    err = max_err(got, want)
                    tol = TOL_FP32 if dt == torch.float32 else TOL_BF16
                    check(torch.allclose(got.float(), want.float(), **tol),
                          f"swin stage {si} masked={masked} {dt}: max abs "
                          f"err {err}")
                    (errs if dt == torch.float32 else errs16).append(err)
                    if path == "captioning":
                        # The bf16 softmax chain at every stage shape.
                        got = swin_attention(q, k, v, scale, bias, wm,
                                             torch.bfloat16)
                        torch.cuda.synchronize()
                        want = swin_attention_plain(q, k, v, scale, bias, wm,
                                                    torch.bfloat16)
                        c = chain_errors(got, want)
                        chain.append(dict(stage=si, masked=masked,
                                          dtype=dtype_name(dt), **c))
                        check(chain_ok(c), f"swin bf16 chain stage {si} "
                              f"masked={masked} {dt}: {c}")
                q, k, v = (torch.randn(Bn, H, SWIN_N, SWIN_D, generator=gen,
                                       device="cuda").to(dtype)
                           for _ in range(3))
                ms, host = time_both(lambda: swin_attention(q, k, v, scale,
                                                            bias, wm))
                plain = time_ms(lambda: swin_attention_plain(
                    q, k, v, scale, bias, wm), 20)
                yard_fn = swin_yardstick(q, k, v, scale, bias, wm)
                yard = time_ms(yard_fn)
                nbytes = io_bytes(q, k, v, q, bias, scale, wm)
                flops = 4 * Bn * H * SWIN_N * SWIN_N * SWIN_D
                b, by = bound_ms(nbytes, flops, dtype_name(dtype))
                shapes.append(dict(
                    stage=si, path=path, shape=[Bn, H, SWIN_N, SWIN_D],
                    masked=masked, dtype=dtype_name(dtype), per_path=count,
                    ms=ms, host_ms=host, plain_ms=plain, library_ms=None,
                    yardstick_ms=yard,
                    yardstick=sdpa_backends(yard_fn), bound_ms=b,
                    bound_by=by, bytes=nbytes, flops=flops))
                print(f"swin {path} stage {si} Bn={Bn} H={H} masked={masked}"
                      f" {dtype_name(dtype)}: kernel {ms:.4f} ms, plain "
                      f"{plain:.4f} ms, yardstick (attention part only) "
                      f"{yard:.4f} ms, bound {b:.4f} ms ({by}) [{card}]")
    print(f"swin bf16 softmax chain vs plain: worst share outside the bf16 "
          f"tolerance {max(c['outside'] for c in chain):.2e}, worst mean "
          f"{max(c['mean'] for c in chain):.2e}, worst max "
          f"{max(c['max'] for c in chain):.4f} (tolerance share "
          f"{TOL_SWIN_BF16_CHAIN['outside']}, mean "
          f"{TOL_SWIN_BF16_CHAIN['mean']})")
    extra = check_swin_extra(gen)
    return dict(name="swin_attention_fwd",
                mode="cosine (SwinV2), fp32 and bf16 softmax chains",
                max_abs_err=max(errs), max_abs_err_bf16=max(errs16),
                bf16_chain=chain, extra_shapes=extra, shapes=shapes,
                library_note="none: no single PyTorch call computes it "
                             "(per-head clamped logit scale on L2-normalized"
                             " q and k; SDPA takes one scalar scale and no "
                             "normalization)")


def path_totals(entry: dict) -> None:
    """Sum each timing over one request's (captioning) or one training
    step's (training) launches of the kernel."""
    entry["paths"] = {}
    for path in ("captioning", "training"):
        sh = [s for s in entry["shapes"] if s["path"] == path]
        if not sh:
            continue
        tot = {k: sum(s[k] * s["per_path"] for s in sh)
               for k in ("ms", "plain_ms", "bound_ms")}
        for key in ("library_ms", "yardstick_ms"):
            vals = [s.get(key) for s in sh]
            tot[key] = (None if None in vals else
                        sum(s[key] * s["per_path"] for s in sh))
        t_bytes = sum(s["bytes"] * s["per_path"] for s in sh)
        t_ops = sum(s["flops"] * s["per_path"] / PEAK_FLOP_PER_S[s["dtype"]]
                    for s in sh)
        tot["bound_by"] = ("bytes" if t_bytes / PEAK_BYTES_PER_S >= t_ops
                           else "operations")
        tot["launches_per_path"] = sum(s["per_path"] for s in sh)
        entry["paths"][path] = tot


def print_path_totals(entry: dict, card: str) -> None:
    """Each path's total of a kernel beside that of the kernel it replaced
    (``OLD_PATH_MS``) and SDPA's or the Swin yardstick's, and, for the T5
    forward, kernel against plain at each training shape."""
    for path, tot in entry["paths"].items():
        per = "request" if path == "captioning" else "training step"
        old = OLD_PATH_MS.get((entry["name"], path))
        if tot["library_ms"] is not None:
            lib = f"sdpa {tot['library_ms']:.4f} ms"
        else:
            lib = (f"yardstick (attention part only) "
                   f"{tot['yardstick_ms']:.4f} ms")
        print(f"{entry['name']} per {per} ({tot['launches_per_path']} "
              f"launches): kernel {tot['ms']:.4f} ms"
              + (f" ({old[1]}: {old[0]} ms, {old[2]})" if old else "")
              + f", {lib}, plain {tot['plain_ms']:.4f} ms, bound "
              f"{tot['bound_ms']:.4f} ms ({tot['bound_by']}) [{card}]")
    if entry["name"] == "t5_attention_fwd":
        for s in entry["shapes"]:
            if s["path"] == "training":
                print(f"  {s['name']} {s['shape']} rate={s['rate']}: kernel "
                      f"{s['ms']:.4f} ms vs plain {s['plain_ms']:.4f} ms "
                      f"({s['plain_ms'] / s['ms']:.2f}x)")


# ---------------------------------------------------------------------------
# Phase 3: captioning at full width
# ---------------------------------------------------------------------------


def decoder_passes(ids) -> int:
    """Decoder passes the greedy loop made: it writes columns 1..step and
    stops at max_length - 1 or once every row has emitted eos (id 1)."""
    rows = ids.tolist()
    last = len(rows[0]) - 1
    if all(1 in r[1:] for r in rows):
        last = min(last, max(r.index(1, 1) for r in rows))
    return last


# The host ranges that phases 4-5 read apart in their profiles: the Swin
# backward (a recompute in plain PyTorch, SwinAttentionFn) and the
# optimizer's step.
SWIN_BWD_SPAN, OPT_SPAN = "SwinAttentionFnBackward", "Optimizer.step"


def profile_device(fn, wall_ms: float, card: str, what: str,
                   spans: tuple[str, ...] = ()) -> dict:
    """One more run of ``fn`` under ``torch.profiler``: the device time of
    its kernels, their share of the (unprofiled) wall time, and the kernels
    that take most of it. The profiler slows the host, so the share is taken
    against the time measured without it. ``spans``: names of host ranges
    (an autograd node such as ``SwinAttentionFnBackward``, or
    ``Optimizer.step``) whose kernels' device time is read apart, under
    ``span_ms``: of the ranges whose name holds the span's, the largest
    total (a nested range of the same name holds no more)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # A host range opened by record_function (torch.optim's
    # "Optimizer.step#...") also leaves a device-side annotation that spans
    # its first to its last kernel, gaps included: it is no kernel, and
    # counting it would count its kernels twice.
    device = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels = [e for e in device if not getattr(e, "is_user_annotation",
                                                False)]
    annotations = {e.key: e.device_time_total / 1e3 for e in device
                   if getattr(e, "is_user_annotation", False)}
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy_ms == 0:
        print("device time: not measured (the profiler saw no device "
              "events)")
        return dict(busy_ms=None)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    span_ms = {}
    for span in spans:
        ranges = [e.device_time_total for e in prof.key_averages()
                  if e.device_type != torch.autograd.DeviceType.CUDA
                  and span in e.key]
        span_ms[span] = max(ranges) / 1e3 if ranges else None
    out = dict(busy_ms=busy_ms, busy_share=busy_ms / wall_ms,
               kernel_launches=sum(e.count for e in kernels),
               top=[dict(name=e.key[:120], ms=e.self_device_time_total / 1e3,
                         count=e.count) for e in top], span_ms=span_ms,
               annotation_span_ms=annotations)
    print(f"device busy {busy_ms:.2f} ms of a {wall_ms:.2f} ms {what} "
          f"({100 * busy_ms / wall_ms:.1f}%), "
          f"{out['kernel_launches']} kernel launches [{card}]")
    for t in out["top"]:
        print(f"  {t['ms']:8.3f} ms  x{t['count']:<6d} {t['name']}")
    for key, ms in annotations.items():
        print(f"  (not in busy: the device-side annotation {key} spans "
              f"{ms:.3f} ms)")
    for span, ms in span_ms.items():
        print(f"  device ms under {span}: "
              + ("not measured (no such range)" if ms is None
                 else f"{ms:.3f} ({100 * ms / busy_ms:.1f}% of busy)"))
    return out


def caption(card: str) -> dict:
    import numpy as np
    import torch

    from klab_multimodalmodel_tpu_torch.config import Config
    from klab_multimodalmodel_tpu_torch.infer.captioner import Captioner
    from klab_multimodalmodel_tpu_torch.models.multimodal import (
        MultiModalModel)
    from klab_multimodalmodel_tpu_torch.ops import (swin_attention,
                                                    t5_attention)
    from klab_multimodalmodel_tpu_torch.text import ByteTokenizer

    cfg = Config(use_pallas_attention=True, use_pallas_t5_attention=True,
                 seed=SEED)
    t0 = time.perf_counter()
    model = MultiModalModel(cfg)
    model.init_weights(torch.Generator(device="cuda").manual_seed(cfg.seed))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model: {n_params} parameters, built and initialized in "
          f"{build_s:.2f} s [{card}]")
    check(n_params > 1.1e9, f"full width expected, got {n_params} params")
    tok = ByteTokenizer()
    cap = Captioner(cfg, model, tok)
    rng = np.random.default_rng(SEED)
    size = cfg.swin.image_size
    requests = [rng.integers(0, 256, (BATCH, size, size, 3), dtype=np.uint8)
                for _ in range(REQUESTS + 1)]

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cap.caption(requests[0])  # warm-up: cuBLAS/cuDNN set-up, first builds
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3

    torch.cuda.reset_peak_memory_stats()
    swin_attention.launches = 0
    t5_attention.launches = 0
    per_request, all_ids, texts = [], [], []
    for images in requests[1:]:
        s0, t0_count = swin_attention.launches, t5_attention.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ids = cap.caption_launch(images)
        texts.append(cap.caption_finish(ids))  # reads back: synchronizes
        ms = (time.perf_counter() - t0) * 1e3
        n_swin = swin_attention.launches - s0
        n_t5 = t5_attention.launches - t0_count
        check(n_swin == 24, f"Swin kernel launches per request {n_swin}")
        check(n_t5 == 48, f"T5 kernel launches per request {n_t5}")
        check(tuple(ids.shape) == (BATCH, cfg.generate_max_length),
              f"token shape {tuple(ids.shape)}")
        check(bool((ids[:, 0] == 0).all()), "column 0 is the start token")
        check(bool(((ids >= 0) & (ids < cfg.transformer_t5.vocab_size))
                   .all()), "token ids in the vocabulary")
        per_request.append(dict(ms=ms, passes=decoder_passes(ids.cpu())))
        all_ids.append(ids)
    launches = dict(swin=swin_attention.launches, t5=t5_attention.launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # Encoder half alone, then through the same weights without kernels.
    images = requests[1]
    encode_ms = host_ms(lambda: cap._encode_prefill(images, None))
    enc, _ = cap._encode_prefill(images, None)
    check(tuple(enc.shape) == (BATCH, cfg.swin.num_patches_out + 32,
                               cfg.transformer_t5.d_model),
          f"encoder output shape {tuple(enc.shape)}")
    check(bool(torch.isfinite(enc).all()), "encoder output is finite")

    plain_cfg = dataclasses.replace(cfg, use_pallas_attention=False,
                                    use_pallas_t5_attention=False)
    plain_model = MultiModalModel(plain_cfg)
    plain_model.load_state_dict(model.state_dict(), strict=True)
    plain_cap = Captioner(plain_cfg, plain_model, tok)
    enc_plain, _ = plain_cap._encode_prefill(images, None)
    rel = float((enc - enc_plain).abs().max() / enc_plain.abs().max())
    print(f"encoder output, kernels vs none: max abs diff / max abs = "
          f"{rel:.3e} (tolerance {TOL_ENCODER_REL})")
    check(rel <= TOL_ENCODER_REL, f"encoder kernel-vs-plain rel diff {rel}")
    plain_ids = plain_cap.caption_launch(images)
    agree = float((plain_ids == all_ids[0]).float().mean())
    del plain_model, plain_cap

    mean_ms = sum(r["ms"] for r in per_request) / len(per_request)
    device = profile_device(
        lambda: cap.caption_finish(cap.caption_launch(images)), mean_ms,
        card, "request")
    decode_ms_per_token = sum(
        (r["ms"] - encode_ms) / r["passes"] for r in per_request) / len(
            per_request)
    result = dict(card=card, parameters=n_params, batch=BATCH,
                  requests=per_request, first_request_ms=first_ms,
                  request_ms=mean_ms, encode_ms=encode_ms,
                  decode_ms_per_token=decode_ms_per_token,
                  captions_per_s=BATCH / (mean_ms / 1e3),
                  peak_memory_gb=peak_gb, launches=launches,
                  encoder_rel_diff_vs_plain=rel,
                  token_agreement_vs_plain=agree, device=device,
                  sample_captions=texts[0][:2])
    print("captioning " + json.dumps(result))
    return result


# ---------------------------------------------------------------------------
# Phase 4: training at full width
# ---------------------------------------------------------------------------


def train_batch(cfg, batch: int, seed: int) -> dict:
    """Seeded uint8 images, the COCO prompt padded to max_source_length
    with its mask, and seeded byte-tokenizer captions (random words of
    lowercase letters) padded to max_target_length."""
    import numpy as np

    from klab_multimodalmodel_tpu_torch.data.datasets import COCO_PROMPT
    from klab_multimodalmodel_tpu_torch.text import ByteTokenizer

    rng = np.random.default_rng(seed)
    tok = ByteTokenizer()
    size = cfg.swin.image_size
    src = tok([COCO_PROMPT] * batch, max_length=cfg.max_source_length)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    captions = [" ".join("".join(rng.choice(letters, rng.integers(2, 9)))
                         for _ in range(rng.integers(4, 16)))
                for _ in range(batch)]
    tgt = tok(captions, max_length=cfg.max_target_length)
    return dict(images=rng.integers(0, 256, (batch, size, size, 3),
                                    dtype=np.uint8),
                source_ids=src.input_ids, source_mask=src.attention_mask,
                target_ids=tgt.input_ids, target_mask=tgt.attention_mask)


def launch_counts() -> dict:
    from klab_multimodalmodel_tpu_torch.ops import (swin_attention,
                                                    t5_attention,
                                                    t5_attention_bwd)
    return dict(t5_fwd=t5_attention.launches,
                t5_fwd_dropout=t5_attention.launches_dropout,
                t5_bwd=t5_attention_bwd.launches,
                t5_bwd_dbias=t5_attention_bwd.launches_dbias,
                swin=swin_attention.launches)


def reset_counts() -> None:
    from klab_multimodalmodel_tpu_torch.ops import (swin_attention,
                                                    t5_attention,
                                                    t5_attention_bwd)
    t5_attention.launches = t5_attention.launches_dropout = 0
    t5_attention_bwd.launches = t5_attention_bwd.launches_dbias = 0
    swin_attention.launches = 0


STEP_LAUNCHES = dict(t5_fwd=96, t5_fwd_dropout=72, t5_bwd=72,
                     t5_bwd_dbias=48, swin=24)
# Trainable parameters of phase 4's step: t5-large (shared embedding, both
# stacks) and the vision projection; phase 5a adds the SwinV2 tower's.
TRAINABLE_T5_PROJ = 738_716_672


def free() -> None:
    """Collect what the caller has dropped and return the card's cached
    blocks, so the next model starts from an empty card."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def timed_steps(trainer, batch, gen, steps: int, expected: dict,
                what: str) -> tuple[list[float], list[float], dict]:
    """(step ms, losses, launches of one step): ``steps`` steps after the
    caller's warm-up, the launch counts set to 0 just before them and read
    just after, each step's launches checked against ``expected``."""
    import torch

    reset_counts()
    step_ms, losses = [], []
    for _ in range(steps):
        before = launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = trainer.train_step(batch, gen)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
        after = launch_counts()
        got = {k: after[k] - before[k] for k in after}
        check(got == expected, f"{what}: launches in one step {got}, "
              f"expected {expected}")
    return step_ms, losses, got


def loss_and_grads(trainer, batch: dict) -> tuple[float, dict]:
    """Loss and trainable gradients of one deterministic (dropout off)
    forward and backward, no update."""
    import torch

    from klab_multimodalmodel_tpu_torch.data.image_ops import (
        normalize_images)
    model = trainer.model
    model.zero_grad(set_to_none=True)
    b = trainer.to_device(batch)
    images = normalize_images(b["images"], dtype=trainer.policy.compute_dtype)
    loss = model(images, b["source_ids"], b["target_ids"], b["source_mask"],
                 b["target_mask"], deterministic=True).loss
    loss.backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()
             if p.grad is not None}
    model.zero_grad(set_to_none=True)
    return float(loss.detach()), grads


def plain_backward_attention(fp32: bool):
    """A stand-in for the model's ``t5_attention`` in the comparisons of
    phase 4: the forward kernel, then the plain backward
    (``t5_attention_bwd_plain``: the backward kernel's math and roundings),
    or, with ``fp32``, the plain backward on fp32 copies of its inputs, so
    that neither dS nor the dropped probabilities are rounded to bf16."""
    import torch

    from klab_multimodalmodel_tpu_torch.ops import (t5_attention_bwd_plain,
                                                    t5_attention_fwd)

    class Fn(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, bias_h, kmask, seed, rate):
            out, _ = t5_attention_fwd(q, k, v, bias_h, kmask, rate, seed)
            ctx.rate = rate
            ctx.save_for_backward(q, k, v, bias_h, kmask, seed)
            return out

        @staticmethod
        def backward(ctx, dout):
            q, k, v, bias_h, kmask, seed = ctx.saved_tensors
            ins = (q, k, v, dout)
            if fp32:
                ins = tuple(t.float() for t in ins)
            need_dbias = bias_h is not None and ctx.needs_input_grad[3]
            dq, dk, dv, dbias = t5_attention_bwd_plain(
                *ins, bias_h, kmask, ctx.rate, seed, need_dbias)
            return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dbias,
                    None, None, None)

    def attention(q, k, v, bias_h=None, kmask=None, dropout_rate=0.0,
                  seed=None):
        return Fn.apply(q, k, v, bias_h, kmask, seed, float(dropout_rate))
    return attention


def attention_fp32_dp(q, k, v, bias=None, dropout_rate=0.0,
                      generator=None):
    """A stand-in for the model's ``dot_product_attention`` (the path
    without kernels) at rate 0: the same forward values, with the
    probabilities rounded to the compute dtype, but a gradient that reaches
    them in fp32, so that dP is not rounded to bf16."""
    check(dropout_rate == 0, "the fp32-dP stand-in runs without dropout")
    logits = q.float() @ k.float().transpose(-1, -2)
    if bias is not None:
        logits = logits + bias.float()
    p = logits.softmax(-1)
    p = p + (p.to(q.dtype).float() - p).detach()
    return (p @ v.float()).to(q.dtype)


# Phase 4's paths, each on the same weights: the kernels; the forward kernel
# and the plain backward, in the io dtype or in fp32; none; none with dP kept
# in fp32. Value: (kernel flags, the model's t5_attention or None to keep it,
# the model's dot_product_attention or None).
PATHS = {
    "kernels": (True, None, None),
    "plain_backward": (True, lambda: plain_backward_attention(False), None),
    "plain_backward_fp32": (True, lambda: plain_backward_attention(True),
                            None),
    "none": (False, None, None),
    "none_fp32_dp": (False, None, lambda: attention_fp32_dp),
}


def path_grads(cfg, state: dict, compute_dtype: str, batch: dict,
               path: str) -> tuple[float, dict]:
    """Loss and trainable gradients on the weights ``state``, dropout off,
    in ``compute_dtype``, through ``PATHS[path]``."""
    import torch

    from klab_multimodalmodel_tpu_torch.models import t5
    from klab_multimodalmodel_tpu_torch.train.trainer import Trainer

    kernels, t5_attention, attention = PATHS[path]
    c = dataclasses.replace(cfg, compute_dtype=compute_dtype,
                            use_pallas_attention=kernels,
                            use_pallas_t5_attention=kernels)
    t = Trainer(c)
    t.init_state(state_dict=state)
    saved = t5.t5_attention, t5.dot_product_attention
    if t5_attention is not None:
        t5.t5_attention = t5_attention()
    if attention is not None:
        t5.dot_product_attention = attention()
    try:
        out = loss_and_grads(t, batch)
    finally:
        t5.t5_attention, t5.dot_product_attention = saved
    del t
    torch.cuda.empty_cache()
    return out


def agreement(a: tuple[float, dict], b: tuple[float, dict], what: str,
              tol: dict | None) -> dict:
    """Loss and per-tensor gradient agreement of run ``a`` against run
    ``b``; printed, and checked against ``tol`` unless it is None."""
    (loss_a, grads_a), (loss_b, grads_b) = a, b
    check(grads_a.keys() == grads_b.keys(), "the same trainable tensors")
    loss_rel = abs(loss_a - loss_b) / abs(loss_b)
    worst_cos, worst_norm = (1.0, ""), (0.0, "")
    dot = na = nb = 0.0
    cosines, norms = {}, {}
    for n, ga in grads_a.items():
        gb = grads_b[n].float()
        ga = ga.float()
        d, x, y = float((ga * gb).sum()), float(ga.norm()), float(gb.norm())
        cos, norm = d / (x * y), abs(x / y - 1)
        check(math.isfinite(cos) and math.isfinite(norm),
              f"gradient of {n}: cosine {cos}, norm ratio off by {norm}")
        worst_cos = min(worst_cos, (cos, n))
        worst_norm = max(worst_norm, (norm, n))
        cosines[n], norms[n] = cos, y
        dot, na, nb = dot + d, na + x * x, nb + y * y
    total = dot / math.sqrt(na * nb)
    # How many tensors fall under cosine 0.99, and how large the worst one's
    # gradient is beside the largest (a small gradient that cancels over
    # many positions moves most under a change of rounding).
    below = sum(c < 0.99 for c in cosines.values())
    worst_share = norms[worst_cos[1]] / max(norms.values())
    tols = ("not checked" if tol is None else
            f"tolerances: loss {TOL_TRAIN_LOSS_REL}, cosine >= "
            f"{tol['cosine']}, norm {tol['norm']}, all >= {tol['total']}")
    print(f"training, {what} (batch {CMP_BATCH}, dropout off): loss "
          f"{loss_a:.6f} vs {loss_b:.6f}, rel {loss_rel:.2e}; worst "
          f"gradient cosine {worst_cos[0]:.6f} ({worst_cos[1]}, its gradient's"
          f" norm {worst_share:.2e} of the largest); {below} tensors under "
          f"cosine 0.99; worst norm ratio off by {worst_norm[0]:.2e} "
          f"({worst_norm[1]}); all {len(grads_a)} tensors together: cosine "
          f"{total:.6f} ({tols})")
    if tol is not None:
        check(loss_rel <= TOL_TRAIN_LOSS_REL,
              f"{what}: loss rel diff {loss_rel}")
        check(worst_cos[0] >= tol["cosine"],
              f"{what}: gradient cosine {worst_cos}")
        check(worst_norm[0] <= tol["norm"],
              f"{what}: gradient norm {worst_norm}")
        check(total >= tol["total"],
              f"{what}: gradient cosine of all tensors {total}")
    return dict(loss_a=loss_a, loss_b=loss_b, loss_rel=loss_rel,
                worst_cosine=worst_cos, worst_norm_rel=worst_norm,
                total_cosine=total, tolerance=tol, under_0_99=below,
                worst_cosine_norm_share=worst_share)


def compare_paths(cfg, state: dict, batch: dict) -> dict:
    """Kernels against none on the weights ``state`` in fp32 compute; in
    bf16 compute the kernels against the forward kernel with the plain
    backward, then against none, with the readings that locate the gap
    beside it (see TOL_TRAIN_GRAD)."""
    out = {}
    kernels = path_grads(cfg, state, "float32", batch, "kernels")
    none = path_grads(cfg, state, "float32", batch, "none")
    out["float32"] = dict(kernels_vs_none=agreement(
        kernels, none, "float32, kernels vs none", TOL_TRAIN_GRAD))
    del kernels, none
    runs = {p: path_grads(cfg, state, "bfloat16", batch, p) for p in PATHS}
    bf16 = {}
    for a, b, tol in (
            ("kernels", "plain_backward", TOL_TRAIN_GRAD),
            ("kernels", "none", TOL_TRAIN_GRAD_BF16_VS_NONE),
            ("plain_backward", "none", None),
            ("plain_backward_fp32", "none", None),
            ("kernels", "none_fp32_dp", None),
            ("none", "none_fp32_dp", None),
            ("plain_backward_fp32", "none_fp32_dp", None)):
        bf16[f"{a}_vs_{b}"] = agreement(runs[a], runs[b],
                                        f"bfloat16, {a} vs {b}", tol)
    out["bfloat16"] = bf16
    return out


def train(card: str) -> dict:
    import torch

    from klab_multimodalmodel_tpu_torch.config import Config
    from klab_multimodalmodel_tpu_torch.train.trainer import Trainer

    cfg = Config(use_pallas_attention=True, use_pallas_t5_attention=True,
                 seed=SEED)
    check(cfg.compute_dtype == "bfloat16" and cfg.lr == 1e-3
          and cfg.lr_scheduler == "" and not cfg.image_model_train,
          "the reference caption recipe's Config defaults")
    t0 = time.perf_counter()
    trainer = Trainer(cfg)
    model = trainer.init_state(
        torch.Generator(device="cuda").manual_seed(cfg.seed))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    n_train = sum(p.numel() for p in model.parameters() if p.requires_grad)
    print(f"training model: {n_params} parameters, {n_train} trainable, "
          f"built in {time.perf_counter() - t0:.2f} s [{card}]")
    check(n_train > 7e8, f"trainable t5-large expected, got {n_train}")
    frozen = {n: p.detach().clone() for n, p in model.named_parameters()
              if not p.requires_grad}
    relpos = {s: getattr(model.transformer, s).relative_attention_bias
              .weight.detach().clone() for s in ("encoder", "decoder")}
    batch = train_batch(cfg, TRAIN_BATCH, SEED)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [float(trainer.train_step(batch, gen))]  # warm-up step
    first_ms = (time.perf_counter() - t0) * 1e3

    torch.cuda.reset_peak_memory_stats()
    step_ms, timed, _ = timed_steps(trainer, batch, gen, STEPS, STEP_LAUNCHES,
                                    "training step")
    losses += timed
    launches = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"losses (warm-up, then {STEPS} steps, dropout on): "
          + ", ".join(f"{x:.4f}" for x in losses))
    check(all(math.isfinite(x) for x in losses), f"non-finite loss {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    for n, p in model.named_parameters():
        if n in frozen:
            check(torch.equal(p, frozen[n]), f"frozen {n} changed")
    for s, w in relpos.items():
        moved = float((getattr(model.transformer, s).relative_attention_bias
                       .weight.detach() - w).abs().max())
        print(f"{s} relative_attention_bias moved by {moved:.3e}")
        check(moved > 0, f"{s} relative_attention_bias did not move")
    mean_ms = sum(step_ms) / len(step_ms)
    print(f"train step: {mean_ms:.2f} ms mean over {STEPS} "
          f"({', '.join(f'{t:.2f}' for t in step_ms)}), "
          f"{TRAIN_BATCH / (mean_ms / 1e3):.2f} images/s, first step "
          f"{first_ms:.2f} ms, peak memory {peak_gb:.2f} GB [{card}]")
    device = profile_device(lambda: trainer.train_step(batch, gen), mean_ms,
                            card, "training step", (OPT_SPAN,))

    # Kernels against none (and, in bf16, against the plain backward):
    # batch 8, dropout off, the same weights, in fp32 and in bf16 compute.
    cmp_batch = train_batch(cfg, CMP_BATCH, SEED + 2)
    state = model.state_dict()
    vs_plain = compare_paths(cfg, state, cmp_batch)
    result = dict(card=card, parameters=n_params, trainable=n_train,
                  batch=TRAIN_BATCH, losses=losses, first_step_ms=first_ms,
                  step_ms=step_ms, mean_step_ms=mean_ms,
                  images_per_s=TRAIN_BATCH / (mean_ms / 1e3),
                  peak_memory_gb=peak_gb, launches=launches,
                  launches_per_step=STEP_LAUNCHES, device=device,
                  vs_plain=vs_plain)
    print("training " + json.dumps(result))
    return result


# ---------------------------------------------------------------------------
# Phase 5: the train_with_swin recipe and the training options
# ---------------------------------------------------------------------------

OPTION_STEPS = 3
# Phase 5c's runs: the _tpu_fast recipes' storage, Adafactor, and the two
# remat policies, each with the frozen towers and both kernel flags on.
OPTIONS = {
    "bf16 frozen towers + bf16 Adam mu": dict(frozen_param_dtype="bfloat16",
                                              adam_mu_dtype="bfloat16"),
    "adafactor": dict(optimizer="adafactor"),
    "remat full": dict(remat="full"),
    "remat dots_saveable": dict(remat="dots_saveable"),
}
# Under remat each of the transformer's 72 attention calls runs its forward
# kernel again in the backward's recompute, at the same rate.
REMAT_LAUNCHES = dict(STEP_LAUNCHES, t5_fwd=96 + 72, t5_fwd_dropout=72 + 72)


def train_swin(card: str) -> tuple[dict, dict]:
    """5a: the train_with_swin recipe at full width, the SwinV2 tower
    trainable, both kernel flags on, batch 32, bf16. Returns the results
    and the trained weights (a state dict on the card) for 5b."""
    import torch

    from klab_multimodalmodel_tpu_torch.config import Config
    from klab_multimodalmodel_tpu_torch.train.trainer import Trainer

    cfg = Config(image_model_train=True, use_pallas_attention=True,
                 use_pallas_t5_attention=True, seed=SEED)
    trainer = Trainer(cfg)
    model = trainer.init_state(
        torch.Generator(device="cuda").manual_seed(cfg.seed))
    n_swin = sum(p.numel() for p in model.image_model.parameters())
    n_train = sum(p.numel() for p in model.parameters() if p.requires_grad)
    print(f"train_with_swin model: {n_train} trainable parameters, "
          f"{n_swin} of them the SwinV2 tower's [{card}]")
    check(n_train == TRAINABLE_T5_PROJ + n_swin and 8e7 < n_swin < 9e7,
          f"trainable t5-large + projection + SwinV2-base expected, got "
          f"{n_train} ({n_swin} Swin)")
    text = {n: p.detach().clone()
            for n, p in model.language_model.named_parameters()}
    swin = {n: p.detach().clone()
            for n, p in model.image_model.named_parameters()}
    batch = train_batch(cfg, TRAIN_BATCH, SEED)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    first = float(trainer.train_step(batch, gen))  # warm-up step
    first_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.reset_peak_memory_stats()
    step_ms, losses, per_step = timed_steps(trainer, batch, gen, STEPS,
                                            STEP_LAUNCHES, "train_with_swin")
    launches = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [first] + losses
    print(f"train_with_swin losses (warm-up, then {STEPS} steps, dropout "
          f"on): " + ", ".join(f"{x:.4f}" for x in losses))
    check(all(math.isfinite(x) for x in losses), f"non-finite loss {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    for n, p in model.language_model.named_parameters():
        check(torch.equal(p, text[n]), f"text tower {n} changed")
    moved = {n: float((p.detach() - swin[n]).abs().max())
             for n, p in model.image_model.named_parameters()}
    still = [n for n, m in moved.items() if m == 0]
    check(not still, f"Swin tensors that did not move: {still}")
    print(f"every SwinV2 tensor moved ({len(moved)}), the least by "
          f"{min(moved.values()):.3e} "
          f"({min(moved, key=moved.get)}); the text tower is unchanged")
    mean_ms = sum(step_ms) / len(step_ms)
    print(f"train_with_swin step: {mean_ms:.2f} ms mean over {STEPS} "
          f"({', '.join(f'{t:.2f}' for t in step_ms)}), "
          f"{TRAIN_BATCH / (mean_ms / 1e3):.2f} images/s, first step "
          f"{first_ms:.2f} ms, peak memory {peak_gb:.2f} GB [{card}]")
    device = profile_device(lambda: trainer.train_step(batch, gen), mean_ms,
                            card, "train_with_swin step",
                            (SWIN_BWD_SPAN, OPT_SPAN))
    state = model.state_dict()
    del trainer, model, text, swin
    free()
    result = dict(card=card, trainable=n_train, swin_parameters=n_swin,
                  batch=TRAIN_BATCH, losses=losses, first_step_ms=first_ms,
                  step_ms=step_ms, mean_step_ms=mean_ms,
                  images_per_s=TRAIN_BATCH / (mean_ms / 1e3),
                  peak_memory_gb=peak_gb, launches=launches,
                  launches_per_step=per_step, device=device,
                  swin_backward_ms=device.get("span_ms", {}).get(
                      SWIN_BWD_SPAN),
                  least_swin_move=min(moved.values()))
    return result, state


def swin_kernel_vs_none(state: dict) -> dict:
    """5b: batch 8, dropout off, the 5a weights: the loss and every SwinV2
    gradient with the Swin kernel against the same path without it (the T5
    kernels on in both), checked at phase 4's tolerances in fp32 compute
    and printed beside them in bf16 compute. The two paths differ by
    design in bf16: the one without the kernel (as the JAX package's)
    rounds q̂ and k̂ to bf16 before their product, the kernel's recompute
    (as the JAX package's) keeps them fp32. A third bf16 run, the path
    without the kernel with its attention replaced by
    ``swin_attention_reference``, tells whether the gap comes from that
    difference or from bf16 rounding at large."""
    from klab_multimodalmodel_tpu_torch.config import Config

    cfg = Config(image_model_train=True, use_pallas_t5_attention=True,
                 seed=SEED)
    batch = train_batch(cfg, CMP_BATCH, SEED + 3)
    out = {}
    for dtype, tol in (("float32", TOL_TRAIN_GRAD), ("bfloat16", None)):
        runs = {}
        for flag in (True, False):
            c = dataclasses.replace(cfg, compute_dtype=dtype,
                                    use_pallas_attention=flag)
            runs[flag] = swin_grads(c, state, batch)
        out[dtype] = agreement(runs[True], runs[False],
                               f"{dtype}, SwinV2 gradients, Swin kernel vs "
                               "none", tol)
    c = dataclasses.replace(cfg, compute_dtype="bfloat16")
    runs["fp32_qk"] = swin_grads(c, state, batch, fp32_qk=True)
    out["bfloat16_vs_fp32_qk"] = agreement(
        runs[True], runs["fp32_qk"], "bfloat16, SwinV2 gradients, Swin "
        "kernel vs none with fp32 q-hat and k-hat", None)
    out["bfloat16_none_vs_fp32_qk"] = agreement(
        runs[False], runs["fp32_qk"], "bfloat16, SwinV2 gradients, none vs "
        "none with fp32 q-hat and k-hat", None)
    return out


def swin_grads(cfg, state: dict, batch: dict,
               fp32_qk: bool = False) -> tuple[float, dict]:
    """Loss and the SwinV2 tower's gradients of one deterministic forward
    and backward on the weights ``state``; with ``fp32_qk`` the path
    without the Swin kernel attends through ``swin_attention_reference``
    (see ``swin_kernel_vs_none``)."""
    from klab_multimodalmodel_tpu_torch.models import swinv2
    from klab_multimodalmodel_tpu_torch.ops import swin_attention_reference
    from klab_multimodalmodel_tpu_torch.train.trainer import Trainer

    t = Trainer(cfg)
    t.init_state(state_dict=state)
    saved = swinv2.WindowAttention._reference_attention
    if fp32_qk:
        swinv2.WindowAttention._reference_attention = (
            lambda self, q, k, v, scale, bias_h, mask:
            swin_attention_reference(q, k, v, scale, bias_h, mask,
                                     self.softmax_dtype))
    try:
        loss, grads = loss_and_grads(t, batch)
    finally:
        swinv2.WindowAttention._reference_attention = saved
    del t
    free()
    return loss, {n: g for n, g in grads.items()
                  if n.startswith("image_model.")}


def train_options(card: str, phase4: dict) -> dict:
    """5c: three timed steps of each of ``OPTIONS`` at batch 32 with the
    frozen towers and both kernel flags on, beside phase 4's step: step ms,
    the optimizer's device time (profile) and peak memory."""
    import torch

    from klab_multimodalmodel_tpu_torch.config import Config
    from klab_multimodalmodel_tpu_torch.train.trainer import Trainer

    dev4 = phase4["device"]
    rows = {"phase 4 (fp32 frozen towers, Adam)": dict(
        mean_step_ms=phase4["mean_step_ms"],
        peak_memory_gb=phase4["peak_memory_gb"],
        optimizer_ms=dev4.get("span_ms", {}).get(OPT_SPAN),
        optimizer_span_ms=optimizer_span(dev4),
        busy_ms=dev4.get("busy_ms"))}
    for name, overrides in OPTIONS.items():
        cfg = Config(use_pallas_attention=True, use_pallas_t5_attention=True,
                     seed=SEED, **overrides)
        trainer = Trainer(cfg)
        model = trainer.init_state(
            torch.Generator(device="cuda").manual_seed(cfg.seed))
        if cfg.frozen_param_dtype == "bfloat16":
            check(all(p.dtype == torch.bfloat16 for n, p in
                      model.named_parameters() if not p.requires_grad),
                  f"{name}: frozen parameters in bf16")
        batch = train_batch(cfg, TRAIN_BATCH, SEED)
        gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
        first = float(trainer.train_step(batch, gen))  # warm-up step
        torch.cuda.reset_peak_memory_stats()
        expected = REMAT_LAUNCHES if cfg.remat else STEP_LAUNCHES
        step_ms, losses, per_step = timed_steps(
            trainer, batch, gen, OPTION_STEPS, expected, name)
        losses = [first] + losses
        check(all(math.isfinite(x) for x in losses),
              f"{name}: non-finite loss {losses}")
        check(losses[-1] < losses[0], f"{name}: loss did not fall {losses}")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        mean_ms = sum(step_ms) / len(step_ms)
        print(f"{name}: losses " + ", ".join(f"{x:.4f}" for x in losses)
              + f"; step {mean_ms:.2f} ms ({', '.join(f'{t:.2f}' for t in step_ms)}),"
              f" peak memory {peak_gb:.2f} GB, launches per step {per_step} "
              f"[{card}]")
        device = profile_device(lambda: trainer.train_step(batch, gen),
                                mean_ms, card, f"{name} step", (OPT_SPAN,))
        rows[name] = dict(mean_step_ms=mean_ms, step_ms=step_ms,
                          peak_memory_gb=peak_gb, losses=losses,
                          optimizer_ms=device.get("span_ms", {}).get(
                              OPT_SPAN),
                          optimizer_span_ms=optimizer_span(device),
                          busy_ms=device.get("busy_ms"),
                          launches_per_step=per_step)
        del trainer, model
        free()
    print(f"training options, batch {TRAIN_BATCH}, bf16 compute, "
          f"{OPTION_STEPS} timed steps each [{card}]:")
    print("  (optimizer: its kernels' device time and their share of busy;"
          " span: first to last of its kernels on the device, gaps "
          "included)")
    print(f"  {'run':40s} {'step ms':>9s} {'busy ms':>9s} "
          f"{'optimizer ms (share)':>21s} {'span ms':>9s} {'peak GB':>8s}")
    for name, r in rows.items():
        opt, busy, span = (r["optimizer_ms"], r["busy_ms"],
                           r["optimizer_span_ms"])
        opt_txt = ("not measured" if opt is None or not busy
                   else f"{opt:.3f} ({100 * opt / busy:.1f}%)")
        busy_txt = "not measured" if busy is None else f"{busy:.2f}"
        span_txt = "not measured" if span is None else f"{span:.2f}"
        print(f"  {name:40s} {r['mean_step_ms']:9.2f} {busy_txt:>9s} "
              f"{opt_txt:>21s} {span_txt:>9s} {r['peak_memory_gb']:8.2f}")
    return rows


def optimizer_span(device: dict):
    """The device-side span of the optimizer's step in a profile (see
    ``profile_device``), or None."""
    spans = [ms for key, ms in device.get("annotation_span_ms", {}).items()
             if key.startswith(OPT_SPAN)]
    return spans[0] if spans else None


# ---------------------------------------------------------------------------
# Phase 6: the training loop at full width
# ---------------------------------------------------------------------------

# The synthetic dataset's 64 rows at batch 32: two updates and two
# validation batches an epoch; B1 halts after update 3 (epoch 2, cursor 1).
LOOP_ROWS, LOOP_EPOCHS, LOOP_HALT = 64, 2, 3
LOOP_UPDATES = LOOP_EPOCHS * LOOP_ROWS // TRAIN_BATCH
# Launches of one call of each step kind that train() makes: a full step
# (images through both towers), a step from cached tower features (the
# towers skipped: no Swin launch, no text-tower launch), and the two kinds of
# validation batch (dropout off, no backward).
LOOP_LAUNCHES = {
    "full step": STEP_LAUNCHES,
    "cached step": dict(STEP_LAUNCHES, t5_fwd=72, swin=0),
    "full eval": dict(t5_fwd=96, t5_fwd_dropout=0, t5_bwd=0, t5_bwd_dbias=0,
                      swin=24),
    "cached eval": dict(t5_fwd=72, t5_fwd_dropout=0, t5_bwd=0,
                        t5_bwd_dbias=0, swin=0),
}


class LoopRecorder:
    """Wraps the ``Trainer``'s four step methods, and the host calls of the
    loop that ``HOST`` names, while phase 6 drives ``train()``. Per step
    call: its kind, its launches (the counts before and after it), its span
    on the device (CUDA events around it, read after the run: nothing
    synchronizes inside it), its host time and its peak memory.
    ``profile``: {kind: (n, wall_ms)} runs the n-th call of that kind under
    the profiler (``profile_device``), with a synchronize before it, its
    busy share taken against ``wall_ms`` (None: the mean span of the kind's
    calls before it). ``host_ms`` / ``host_calls``: host time and calls of
    each ``HOST`` entry; ``data wait`` is the time the loop waited for the
    loader's next batch."""

    METHODS = ("train_step", "train_step_with_features", "eval_step",
               "eval_step_with_features")
    # label: (module, class, method)
    HOST = {
        "to_device": ("train.trainer", "Trainer", "to_device"),
        "fill: start the copy": ("train.trainer", "Trainer", "copy_to_host"),
        "fill: wait for the copy": ("train.trainer", "HostCopy", "wait"),
        "fill: write the cache": ("train.feature_cache",
                                  "FrozenFeatureCache", "put"),
        "cache read": ("train.feature_cache", "FrozenFeatureCache", "get"),
        "cache flush": ("train.feature_cache", "FrozenFeatureCache",
                        "flush"),
        "epoch close (loss sync)": ("obs.metrics", "LossCounter",
                                    "count_and_get_loss"),
        "checkpoint save (stall)": ("checkpoint.io", "CheckpointManager",
                                    "save"),
        "checkpoint wait": ("checkpoint.io", "CheckpointManager", "wait"),
        "checkpoint restore": ("checkpoint.io", "CheckpointManager",
                               "restore"),
    }

    def __init__(self, card: str, profile: dict | None = None):
        self.card = card
        self.profile = profile or {}
        self.calls: list[dict] = []
        self.profiles: dict = {}
        self.host_ms = {k: 0.0 for k in [*self.HOST, "data wait"]}
        self.host_calls = dict.fromkeys(self.host_ms, 0)

    def __enter__(self):
        import importlib

        from klab_multimodalmodel_tpu_torch.data.pipeline import DataLoader
        from klab_multimodalmodel_tpu_torch.train.trainer import Trainer

        self._saved = [(Trainer, n, getattr(Trainer, n))
                       for n in self.METHODS]
        for name in self.METHODS:
            setattr(Trainer, name, self._step(name, getattr(Trainer, name)))
        for label, (mod, cls_name, name) in self.HOST.items():
            cls = getattr(importlib.import_module(
                f"klab_multimodalmodel_tpu_torch.{mod}"), cls_name)
            self._saved.append((cls, name, getattr(cls, name)))
            setattr(cls, name, self._timed(getattr(cls, name), label))
        self._saved.append((DataLoader, "iter_from", DataLoader.iter_from))
        DataLoader.iter_from = self._timed_iter(DataLoader.iter_from)
        return self

    def __exit__(self, *exc):
        for cls, name, orig in reversed(self._saved):
            setattr(cls, name, orig)

    def _add(self, label: str, t0: float) -> None:
        self.host_ms[label] += (time.perf_counter() - t0) * 1e3
        self.host_calls[label] += 1

    def _timed(self, orig, label: str):
        rec = self

        def call(*args, **kw):
            t0 = time.perf_counter()
            try:
                return orig(*args, **kw)
            finally:
                rec._add(label, t0)
        return call

    def _timed_iter(self, orig):
        rec = self

        def iter_from(loader, start_batch):
            it = orig(loader, start_batch)
            while True:
                t0 = time.perf_counter()
                try:
                    item = next(it)
                except StopIteration:
                    return
                finally:
                    rec._add("data wait", t0)
                yield item
        return iter_from

    def _step(self, name: str, orig):
        import torch

        rec = self

        def call(trainer, batch, *args):
            kind = (("cached " if "image_features" in batch else "full ")
                    + ("eval" if name.startswith("eval") else "step"))
            n = 1 + sum(c["kind"] == kind for c in rec.calls)
            profiled = rec.profile.get(kind, (0, 0))[0] == n
            before = launch_counts()
            torch.cuda.reset_peak_memory_stats()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            box = {}
            if profiled:
                torch.cuda.synchronize()
                wall = rec.profile[kind][1]
                if wall is None:  # the mean span of this kind's calls so far
                    spans = [c["events"][0].elapsed_time(c["events"][1])
                             for c in rec.calls if c["kind"] == kind
                             and not c["profiled"]]
                    wall = sum(spans) / len(spans)
                rec.profiles[kind] = profile_device(
                    lambda: box.setdefault("out", orig(trainer, batch, *args)),
                    wall, rec.card, f"phase-6 {kind}")
            else:
                t0 = time.perf_counter()
                start.record()
                box["out"] = orig(trainer, batch, *args)
                end.record()
                host = (time.perf_counter() - t0) * 1e3
            after = launch_counts()
            rec.calls.append(dict(
                kind=kind, profiled=profiled, events=(start, end),
                host_ms=None if profiled else host,
                launches={k: after[k] - before[k] for k in after},
                peak_gb=torch.cuda.max_memory_allocated() / 1e9))
            return box["out"]
        return call

    def summary(self) -> dict:
        """Per kind: calls, mean device span (profiled calls left out),
        peak memory, and the launches of one call, each call's checked."""
        import torch

        torch.cuda.synchronize()
        out = {}
        for c in self.calls:
            check(c["launches"] == LOOP_LAUNCHES[c["kind"]],
                  f"phase 6 {c['kind']}: launches {c['launches']}, expected "
                  f"{LOOP_LAUNCHES[c['kind']]}")
            k = out.setdefault(c["kind"], dict(calls=0, span_ms=[],
                                               host_ms=[], peak_gb=0.0))
            k["calls"] += 1
            k["launches"] = c["launches"]
            k["peak_gb"] = max(k["peak_gb"], c["peak_gb"])
            if not c["profiled"]:
                k["span_ms"].append(c["events"][0].elapsed_time(
                    c["events"][1]))
                k["host_ms"].append(c["host_ms"])
        for k in out.values():
            k["mean_span_ms"] = (sum(k["span_ms"]) / len(k["span_ms"])
                                 if k["span_ms"] else None)
        return out


def loop_determinism(cfg, card: str) -> dict:
    """One training step twice from the same state and generator (the
    first batch of the loop's epoch 1): loss, gradients and updated
    parameters bitwise equal, or the gap that sets the resume check's
    tolerance."""
    import torch

    from klab_multimodalmodel_tpu_torch.data import get_dataloader
    from klab_multimodalmodel_tpu_torch.text import load_tokenizer
    from klab_multimodalmodel_tpu_torch.train.trainer import Trainer

    loader = get_dataloader(cfg, "train", load_tokenizer(""))
    loader.set_epoch(1)
    batch = next(iter(loader))
    batch.pop("index")
    trainer = Trainer(cfg, num_epochs=LOOP_EPOCHS)
    runs = []
    for _ in range(2):
        model = trainer.init_state()
        gen = torch.Generator(device=trainer.device).manual_seed(
            cfg.seed + 1)
        loss = trainer.train_step(batch, gen)
        runs.append(dict(
            loss=float(loss),
            grads={n: p.grad.detach().clone() for n, p in
                   model.named_parameters() if p.grad is not None},
            params={n: p.detach().clone() for n, p in
                    model.named_parameters() if p.requires_grad}))
    a, b = runs
    gap = dict(loss=abs(a["loss"] - b["loss"]),
               grads=max(max_err(a["grads"][n], b["grads"][n])
                         for n in a["grads"]),
               params=max(max_err(a["params"][n], b["params"][n])
                          for n in a["params"]))
    differing = sorted(n for n in a["grads"]
                       if not torch.equal(a["grads"][n], b["grads"][n]))
    bitwise = not differing and gap["loss"] == 0 and gap["params"] == 0
    print(f"determinism: one step twice from the same state and generator: "
          + ("bitwise equal" if bitwise else
             f"differ by loss {gap['loss']:.3e}, gradients "
             f"{gap['grads']:.3e}, parameters {gap['params']:.3e}; "
             f"{len(differing)} gradients differ, e.g. {differing[:5]}")
          + f" ({len(a['grads'])} gradients) [{card}]")
    del trainer, model, runs, a, b
    free()
    return dict(bitwise=bitwise, gap=gap, differing=differing)


def loop_run(cfg, card: str, what: str, profile=None):
    """``train(cfg)`` under a ``LoopRecorder``, the launch counts set to 0
    just before it and read just after: (summary, recorder, launches)."""
    from klab_multimodalmodel_tpu_torch.train import train

    reset_counts()
    t0 = time.perf_counter()
    with LoopRecorder(card, profile) as rec:
        out = train(cfg)
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    steps = rec.summary()
    print(f"phase 6 run {what}: {seconds:.2f} s, {out['steps']} updates, "
          f"halted {out['halted']}, losses {out['losses']}, min_val_loss "
          f"{out['min_val_loss']} [{card}]")
    for kind, k in steps.items():
        span = ("not measured" if k["mean_span_ms"] is None
                else f"{k['mean_span_ms']:.2f}")
        print(f"  {kind}: {k['calls']} calls, device span {span} ms mean "
              f"({', '.join(f'{t:.2f}' for t in k['span_ms'])}), host "
              f"({', '.join(f'{t:.2f}' for t in k['host_ms'])}) ms, peak "
              f"{k['peak_gb']:.2f} GB, launches {k['launches']}")
    print("  host ms (calls): " + ", ".join(
        f"{label} {ms:.2f} ({rec.host_calls[label]})"
        for label, ms in rec.host_ms.items() if rec.host_calls[label]))
    for save in out["saves"]:
        print(f"  save {save['name']}: {save['bytes'] / 1e9:.3f} GB, loop "
              f"stall {save['stall_s']:.3f} s, background write "
              f"{save.get('write_s', float('nan')):.3f} s")
    metrics = [json.loads(line) for line in
               open(os.path.join(cfg.result_dir, "metrics.jsonl"))]
    for row in metrics:
        print(f"  epoch {row['epoch']}: {row['img_per_sec']} images/s over "
              f"{row['epoch_seconds']} s (train {row['train_loss']:.6f}, "
              f"val {row['val_loss']:.6f})")
    result = dict(seconds=seconds, steps=int(out["steps"]),
                  halted=out["halted"], losses=out["losses"],
                  min_val_loss=out["min_val_loss"], step_kinds=steps,
                  profiles=rec.profiles, saves=out["saves"],
                  metrics=metrics, launches=launches, host_ms=rec.host_ms,
                  host_calls=rec.host_calls)
    return result, out


def same(a, b, tol: float) -> bool:
    """Equal, or within ``tol`` where the determinism reading found a
    gap."""
    return a == b if tol == 0 else abs(a - b) <= tol


def loop_phase(card: str) -> dict:
    """Phase 6: ``train(config)`` at full width on the synthetic dataset, four
    runs: A uncached; C with the frozen-feature cache; B1 as C halting after
    update 3; B2 the same command again, which resumes. Holds C's losses to
    A's and B2's losses, steps, min_val_loss and parameters to C's."""
    import shutil
    import tempfile

    import torch

    from klab_multimodalmodel_tpu_torch.config import Config

    root = tempfile.mkdtemp(prefix="chip_smoke_loop_")
    try:
        free_gb = shutil.disk_usage(root).free / 1e9
        print(f"phase 6: {free_gb:.1f} GB free on the disk of {root}")
        base = dict(use_pallas_attention=True, use_pallas_t5_attention=True,
                    seed=SEED, data_dir="synthetic", batch_size=TRAIN_BATCH,
                    num_epochs=LOOP_EPOCHS)
        cfg = Config(**base)
        check(cfg.compute_dtype == "bfloat16" and cfg.lr == 1e-3
              and not cfg.image_model_train
              and cfg.transformer_t5.dropout_rate == RATE,
              "the reference caption recipe's Config defaults")
        det = loop_determinism(cfg, card)
        tol_loss = det["gap"]["loss"]
        tol_param = det["gap"]["params"]

        def config(tag, **kw):
            return Config(**base, result_dir=os.path.join(root, tag), **kw)

        a, out = loop_run(config("A"), card, "A (uncached)",
                            profile={"full step": (4, None)})
        del out
        free()
        shutil.rmtree(os.path.join(root, "A"))

        c, out = loop_run(config("C", cache_frozen_features=True), card,
                            "C (cache_frozen_features)")
        c_params = {n: p.detach().clone()
                    for n, p in out["trainer"].model.named_parameters()
                    if p.requires_grad}
        del out
        free()
        cdir = os.path.join(root, "C")
        for tag in ("train", "val"):
            for kind in ("img", "lang"):
                for suffix in ("", ".mask.npy", ".meta.json"):
                    path = os.path.join(cdir, "feature_cache",
                                        f"{tag}.{kind}.feat{suffix}")
                    check(os.path.exists(path), f"{path} missing")
        check(len(c["metrics"]) == LOOP_EPOCHS,
              f"metrics.jsonl: {len(c['metrics'])} lines")
        for phase in ("train", "val"):
            for x, y in zip(c["losses"][phase], a["losses"][phase]):
                check(same(x, y, tol_loss), f"cached {phase} losses "
                      f"{c['losses'][phase]} vs uncached {a['losses'][phase]}")
        shutil.rmtree(cdir)

        cached_ms = c["step_kinds"]["cached step"]["mean_span_ms"]
        b1, out = loop_run(config("B", cache_frozen_features=True,
                                    halt_after_steps=LOOP_HALT), card,
                             "B1 (halts after update 3)")
        del out
        free()
        check(b1["halted"] and b1["steps"] == LOOP_HALT,
              f"B1 halted {b1['halted']} after {b1['steps']} updates")
        bdir = os.path.join(root, "B", "checkpoints")
        for name in ("best", f"step_{LOOP_HALT}"):
            check(os.path.isdir(os.path.join(bdir, name))
                  and os.path.exists(os.path.join(bdir, f"{name}.meta.json")),
                  f"B1's checkpoint {name} or its sidecar missing")
        # B2 resumes from step_N, not from best; dropping best keeps the
        # disk at two checkpoints (~21 GB) when B2 saves its own.
        shutil.rmtree(os.path.join(bdir, "best"))
        b2, out = loop_run(config("B", cache_frozen_features=True,
                                    halt_after_steps=LOOP_HALT), card,
                             "B2 (the same command: resumes from step_3)",
                             profile={"cached step": (1, cached_ms)})
        check(not b2["halted"] and b2["steps"] == LOOP_UPDATES,
              f"B2 halted {b2['halted']} after {b2['steps']} updates")
        check(b2["losses"] == c["losses"] if tol_loss == 0 else all(
            same(x, y, tol_loss) for p in ("train", "val")
            for x, y in zip(b2["losses"][p], c["losses"][p])),
            f"resumed losses {b2['losses']} vs {c['losses']}")
        check(same(b2["min_val_loss"], c["min_val_loss"], tol_loss),
              f"min_val_loss {b2['min_val_loss']} vs {c['min_val_loss']}")
        param_gap = 0.0
        for n, p in out["trainer"].model.named_parameters():
            if p.requires_grad and not torch.equal(p, c_params[n]):
                param_gap = max(param_gap, max_err(p, c_params[n]))
        check(param_gap <= tol_param, f"resumed parameters differ from the "
              f"uninterrupted run's by {param_gap:.3e} (determinism gap "
              f"{tol_param:.3e})")
        print(f"resume: B2 equals C "
              + ("bitwise" if param_gap == 0 and tol_loss == 0 else
                 f"within the determinism gap (parameters {param_gap:.3e})")
              + f": losses, {b2['steps']} updates, min_val_loss, "
              f"{len(c_params)} trainable tensors [{card}]")
        del out, c_params
        free()
        check(len(b2["metrics"]) == LOOP_EPOCHS,
              f"B's metrics.jsonl: {len(b2['metrics'])} lines")
    finally:
        shutil.rmtree(root, ignore_errors=True)

    full, fill = a["step_kinds"]["full step"], c["step_kinds"]["full step"]
    cached = c["step_kinds"]["cached step"]
    saves = a["saves"] + c["saves"] + b1["saves"] + b2["saves"]
    fills = c["host_calls"]["fill: wait for the copy"]
    fill_ms = (c["host_ms"]["fill: wait for the copy"]
               + c["host_ms"]["fill: write the cache"]) / max(fills, 1)
    busy = (a["profiles"]["full step"].get("busy_ms"),
            b2["profiles"]["cached step"].get("busy_ms"))
    print(f"phase 6 [{card}]: device span per step: full {full['mean_span_ms']:.2f}"
          f" ms (A), full with the cache's fill {fill['mean_span_ms']:.2f} ms "
          f"(C, epoch 1), cached {cached['mean_span_ms']:.2f} ms (C, epoch "
          f"2); device busy of one profiled full / cached step {busy[0]} / "
          f"{busy[1]} ms; peak memory {full['peak_gb']:.2f} / "
          f"{cached['peak_gb']:.2f} GB; images/s by epoch, C: "
          f"{[r['img_per_sec'] for r in c['metrics']]}, A: "
          f"{[r['img_per_sec'] for r in a['metrics']]}; the deferred fill "
          f"blocks the host {fill_ms:.3f} ms per full step; checkpoint "
          f"{saves[0]['bytes'] / 1e9:.3f} GB, loop stall "
          f"{min(s['stall_s'] for s in saves):.3f}-"
          f"{max(s['stall_s'] for s in saves):.3f} s, background write "
          f"{min(s['write_s'] for s in saves):.3f}-"
          f"{max(s['write_s'] for s in saves):.3f} s over {len(saves)} saves")
    return dict(card=card, free_disk_gb=free_gb, determinism=det,
                runs=dict(A=a, C=c, B1=b1, B2=b2), full_step=full,
                fill_step=fill, cached_step=cached, busy_ms=busy,
                fill_host_ms=fill_ms)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "False); nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from klab_multimodalmodel_tpu_torch.ops import cuda_build

    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    cuda_build.build_all()
    build_s = time.perf_counter() - t0
    print(f"kernel build: {build_s:.2f} s")
    build = build_report()

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    kernels = [check_t5_fwd(gen, card), check_t5_bwd(gen, card),
               check_swin(gen, card)]
    for entry in kernels:
        entry["source"], entry["replaces"] = KERNELS[entry["name"]]
        entry["route"] = "cuda"
        path_totals(entry)
        print_path_totals(entry, card)

    # Each main path runs with the counts set to 0 just before it and read
    # just after (inside caption() and train(): the three timed requests,
    # the five timed steps).
    reset_counts()
    captioning = caption(card)
    reset_counts()
    training = train(card)
    free()
    reset_counts()
    swin_training, state = train_swin(card)
    swin_training["swin_kernel_vs_none"] = swin_kernel_vs_none(state)
    del state
    free()
    options = train_options(card, training)
    free()
    looping = loop_phase(card)
    keys = {"t5_attention_fwd": ("t5_fwd", "t5"),
            "t5_attention_bwd": ("t5_bwd", None),
            "swin_attention_fwd": ("swin", "swin")}
    for entry in kernels:
        train_key, caption_key = keys[entry["name"]]
        entry["launches"] = training["launches"][train_key]
        entry["launches_captioning"] = (
            captioning["launches"][caption_key] if caption_key else 0)
        check(entry["launches"] > 0, f"{entry['name']} never launched")
        entry["launches_train_with_swin_step"] = (
            swin_training["launches_per_step"][train_key])
        check(entry["launches_train_with_swin_step"] > 0,
              f"{entry['name']} never launched in train_with_swin")
        c_run = looping["runs"]["C"]
        entry["launches_loop_run"] = c_run["launches"][train_key]
        check(entry["launches_loop_run"] > 0,
              f"{entry['name']} never launched by train()")
        for kind in ("full step", "cached step"):
            entry[f"launches_loop_{kind.replace(' ', '_')}"] = (
                c_run["step_kinds"][kind]["launches"][train_key])
        # The line reports one training step's launches of each kernel.
        entry.update({k: entry["paths"]["training"][k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
    summary = [{k: e.get(k) for k in (
        "name", "route", "source", "replaces", "launches", "max_abs_err",
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
        "launches_captioning", "launches_train_with_swin_step",
        "launches_loop_run", "launches_loop_full_step",
        "launches_loop_cached_step")}
        for e in kernels]
    print(json.dumps({
        "kernels": summary, "card": card,
        "times": f"per training step (all of the kernel's launches in one "
                 f"batch-{TRAIN_BATCH} step, bf16 inputs, warm L2); "
                 f"launches: the {STEPS} timed steps; launches_captioning: "
                 f"the {REQUESTS} timed requests; "
                 f"launches_train_with_swin_step: one step of phase 5a; "
                 f"launches_loop_run: phase 6's run C of train(); "
                 f"launches_loop_full_step / _cached_step: one full and "
                 f"one cached step of that run"}))

    out_dir = os.path.join(REPO, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "build_s": build_s, "build": build,
                   "kernels": kernels,
                   "captioning": captioning, "training": training,
                   "train_with_swin": swin_training, "options": options,
                   "loop": looping}, f, indent=1, default=str)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
