#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it fails:

1. Record the card (``nvidia-smi`` name and power limit) and build both CUDA
   kernels from ``klab_multimodalmodel_tpu_torch/csrc``.
2. Hold each kernel against its plain PyTorch version at the captioning
   path's shapes, in fp32 and bf16, and time kernel, plain version and (for
   T5) ``F.scaled_dot_product_attention`` as a yardstick, with CUDA events.
   Prints one ``{"kernels": [...]}`` line.
3. Caption at full width: SwinV2-base + t5-large text tower + t5-large
   transformer (~1.16 B parameters, fp32, seeded random weights), both
   kernel flags on, three batch-8 requests of seeded 256x256 uint8 images
   with the COCO prompt through ``Captioner``. Checks the kernel launch
   counts of every request (24 Swin, 48 T5), the token layout, a finite
   encoder output, and the encoder output against the same weights run
   without the kernels.
4. Prints ``{"ok": true, "device": {...}}`` as the last line.

It needs one card and exits non-zero, printing no result, where
``torch.cuda.is_available()`` is false. Full results also go to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SOURCE_T5 = "klab_multimodalmodel_tpu_torch/csrc/t5_attention_fwd.cu"
SOURCE_SWIN = "klab_multimodalmodel_tpu_torch/csrc/swin_attention_fwd.cu"
# Both kernels replace modes of the one forward Pallas kernel, _fwd_kernel.
REPLACES = "klab_multimodalmodel_tpu/ops/fused_attention.py:109"

# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W).
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOP_PER_S = 67e12

# Kernel vs plain version: summation order; bf16 also rounds q/k, the
# probabilities and the output (one bf16 ulp of a result near 2-4 is 0.016).
TOL_FP32 = dict(rtol=0.0, atol=1e-4)
TOL_BF16 = dict(rtol=2e-2, atol=2e-2)
# Encoder output with kernels vs without, relative to its largest value:
# fp32 summation order compounded over 24 + 24 + 24 layers.
TOL_ENCODER_REL = 1e-3

BATCH, REQUESTS, SEED = 8, 3, 0
T5_H, T5_D, SWIN_N, SWIN_D = 16, 64, 64, 32


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


def time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of ``fn()`` in ms, by CUDA events over ``iters``
    back-to-back calls after ``warmup`` calls (inputs stay warm in L2, as
    they are when the preceding projection has just written them)."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


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


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def t5_case(L: int, n_masked: int, dtype, gen):
    import torch

    dev = "cuda"
    q, k, v = (torch.randn(BATCH, T5_H, L, T5_D, generator=gen,
                           device=dev).to(dtype) for _ in range(3))
    bias = torch.randn(T5_H, L, L, generator=gen, device=dev)
    kmask = torch.ones(BATCH, L, dtype=torch.int32, device=dev)
    kmask[:, L - n_masked:] = 0
    return q, k, v, bias, kmask


def check_t5(gen, card: str) -> dict:
    import torch
    import torch.nn.functional as F

    from klab_multimodalmodel_tpu_torch.ops import (t5_attention,
                                                    t5_attention_plain)
    # Text tower: 30 prompt ids bucketed to 32 (2 pad keys masked); main
    # encoder: 64 image tokens + those 32.
    shapes, errs, errs16 = [], [], []
    for L, masked, per_request in ((32, 2, 24), (96, 2, 24)):
        for dtype in (torch.float32, torch.bfloat16):
            args = t5_case(L, masked, dtype, gen)
            got = t5_attention(*args)
            torch.cuda.synchronize()
            want = t5_attention_plain(*args)
            err = max_err(got, want)
            tol = TOL_FP32 if dtype == torch.float32 else TOL_BF16
            check(torch.allclose(got.float(), want.float(), **tol),
                  f"t5_attention L={L} {dtype}: max abs err {err}")
            (errs if dtype == torch.float32 else errs16).append(err)
        q, k, v, bias, kmask = t5_case(L, masked, torch.float32, gen)
        mask_bias = torch.where(kmask[:, None, None, :] > 0, 0.0, -1e9)
        attn_mask = (bias[None] + mask_bias).contiguous()
        ms = time_ms(lambda: t5_attention(q, k, v, bias, kmask))
        plain = time_ms(lambda: t5_attention_plain(q, k, v, bias, kmask))
        lib = time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, scale=1.0))
        elems = BATCH * T5_H * L * T5_D
        nbytes = 4 * elems * 4 + bias.numel() * 4 + kmask.numel() * 4
        flops = 4 * BATCH * T5_H * L * L * T5_D
        b, by = bound_ms(nbytes, flops)
        shapes.append(dict(shape=[BATCH, T5_H, L, L, T5_D], dtype="float32",
                           per_request=per_request, ms=ms, plain_ms=plain,
                           library_ms=lib, bound_ms=b, bound_by=by,
                           bytes=nbytes, flops=flops))
        print(f"t5_attention B={BATCH} H={T5_H} L={L} D={T5_D} fp32: "
              f"kernel {ms:.4f} ms, plain {plain:.4f} ms, sdpa {lib:.4f} ms,"
              f" bound {b:.4f} ms ({by}) [{card}]")
    return dict(name="t5_attention_fwd", route="cuda", source=SOURCE_T5,
                replaces=REPLACES, mode="plain (T5), dropout rate 0",
                max_abs_err=max(errs), max_abs_err_bf16=max(errs16),
                shapes=shapes)


def swin_stage_cases():
    """(stage, windows B*nW, heads, nW of the shifted mask, unshifted
    blocks, shifted blocks) per stage of SwinV2-base at 256 px, batch 8."""
    from klab_multimodalmodel_tpu_torch.config import SwinV2Size

    size = SwinV2Size()
    side = size.image_size // size.patch_size
    out = []
    for si, (depth, heads) in enumerate(zip(size.depths, size.num_heads)):
        nW = (side // size.window_size) ** 2 if side > size.window_size else 1
        shifted = depth // 2 if side > size.window_size else 0
        out.append((si, BATCH * nW, heads, nW, depth - shifted, shifted,
                    side))
        side //= 2
    return out


def check_swin(gen, card: str) -> dict:
    import torch

    from klab_multimodalmodel_tpu_torch.models.swinv2 import (
        shifted_window_mask)
    from klab_multimodalmodel_tpu_torch.ops import (swin_attention,
                                                    swin_attention_plain)
    shapes, errs, errs16 = [], [], []
    for si, Bn, H, nW, n_plain, n_shift, side in swin_stage_cases():
        wmask = None
        if n_shift:
            w = int(SWIN_N ** 0.5)
            wmask = torch.tensor(shifted_window_mask(side, side, w, w // 2),
                                 device="cuda")
        scale = (torch.log(torch.tensor(10.0, device="cuda"))
                 + 0.5 * torch.randn(H, generator=gen, device="cuda"))
        bias = 16 * torch.sigmoid(torch.randn(H, SWIN_N, SWIN_N,
                                              generator=gen, device="cuda"))
        for masked, count in ((False, n_plain), (True, n_shift)):
            if count == 0:
                continue
            wm = wmask if masked else None
            for dtype in (torch.bfloat16, torch.float32):
                q, k, v = (torch.randn(Bn, H, SWIN_N, SWIN_D, generator=gen,
                                       device="cuda").to(dtype)
                           for _ in range(3))
                got = swin_attention(q, k, v, scale, bias, wm)
                torch.cuda.synchronize()
                want = swin_attention_plain(q, k, v, scale, bias, wm)
                err = max_err(got, want)
                tol = TOL_FP32 if dtype == torch.float32 else TOL_BF16
                check(torch.allclose(got.float(), want.float(), **tol),
                      f"swin_attention stage {si} masked={masked} {dtype}: "
                      f"max abs err {err}")
                (errs if dtype == torch.float32 else errs16).append(err)
            # q, k, v are the fp32 inputs (the last dtype above): time them.
            ms = time_ms(lambda: swin_attention(q, k, v, scale, bias, wm))
            plain = time_ms(lambda: swin_attention_plain(q, k, v, scale,
                                                         bias, wm))
            elems = Bn * H * SWIN_N * SWIN_D
            nbytes = (4 * elems * 4 + bias.numel() * 4 + H * 4
                      + (wm.numel() * 4 if wm is not None else 0))
            flops = 4 * Bn * H * SWIN_N * SWIN_N * SWIN_D
            b, by = bound_ms(nbytes, flops)
            shapes.append(dict(stage=si, shape=[Bn, H, SWIN_N, SWIN_D],
                               masked=masked, dtype="float32",
                               per_request=count, ms=ms, plain_ms=plain,
                               library_ms=None, bound_ms=b, bound_by=by,
                               bytes=nbytes, flops=flops))
            print(f"swin_attention stage {si} Bn={Bn} H={H} masked={masked}"
                  f" fp32: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
                  f"bound {b:.4f} ms ({by}) [{card}]")
    return dict(name="swin_attention_fwd", route="cuda", source=SOURCE_SWIN,
                replaces=REPLACES, mode="cosine (SwinV2), fp32 softmax",
                max_abs_err=max(errs), max_abs_err_bf16=max(errs16),
                shapes=shapes)


def per_request_totals(entry: dict) -> None:
    """Sum each timing over one request's launches of the kernel."""
    sh = entry["shapes"]
    for key in ("ms", "plain_ms", "bound_ms"):
        entry[key] = sum(s[key] * s["per_request"] for s in sh)
    entry["kernel_ms"] = entry["ms"]
    libs = [s["library_ms"] for s in sh]
    entry["library_ms"] = (None if None in libs else
                           sum(s["library_ms"] * s["per_request"] for s in sh))
    t_bytes = sum(s["bytes"] * s["per_request"] for s in sh)
    t_ops = sum(s["flops"] * s["per_request"] for s in sh)
    t_bytes, t_ops = t_bytes / PEAK_BYTES_PER_S, t_ops / PEAK_FP32_FLOP_PER_S
    entry["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    entry["launches_per_request"] = sum(s["per_request"] for s in sh)


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


def profile_request(cap, images, request_ms: float, card: str) -> dict:
    """One more request under ``torch.profiler``: the device time of its
    kernels, their share of the (unprofiled) request time, and the kernels
    that take most of it. The profiler slows the host, so the share is
    taken against the request time measured without it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        cap.caption_finish(cap.caption_launch(images))
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy_ms == 0:
        print("device time: not measured (the profiler saw no device "
              "events)")
        return dict(busy_ms=None)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    out = dict(busy_ms=busy_ms, busy_share=busy_ms / request_ms,
               kernel_launches=sum(e.count for e in kernels),
               top=[dict(name=e.key[:120], ms=e.self_device_time_total / 1e3,
                         count=e.count) for e in top])
    print(f"device busy {busy_ms:.2f} ms of a {request_ms:.2f} ms request "
          f"({100 * busy_ms / request_ms:.1f}%), "
          f"{out['kernel_launches']} kernel launches [{card}]")
    for t in out["top"]:
        print(f"  {t['ms']:8.3f} ms  x{t['count']:<6d} {t['name']}")
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
    device = profile_request(cap, images, mean_ms, card)
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
    print(f"kernel build: {time.perf_counter() - t0:.2f} s")
    for name, log in cuda_build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    kernels = [check_t5(gen, card), check_swin(gen, card)]
    for entry in kernels:
        per_request_totals(entry)

    captioning = caption(card)
    for entry in kernels:
        key = "t5" if entry["name"].startswith("t5") else "swin"
        entry["launches"] = captioning["launches"][key]
        check(entry["launches"] > 0, f"{entry['name']} never launched")
    summary = [{k: e[k] for k in (
        "name", "route", "source", "replaces", "launches", "max_abs_err",
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "kernel_ms",
        "launches_per_request", "max_abs_err_bf16")} for e in kernels]
    print(json.dumps({"kernels": summary, "card": card,
                      "times": "per request (all of the kernel's launches in"
                               " one batch-8 request), fp32, warm L2"}))

    out_dir = os.path.join(REPO, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "kernels": kernels,
                   "captioning": captioning}, f, indent=1)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
