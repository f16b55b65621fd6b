"""Console entry points of the port, with the JAX package's flags.

``klab-torch-train``: train (``config.build_arg_parser``'s flags).
``klab-torch-eval``: CIDEr-D / BLEU-1..4 / ROUGE-L of a trained run over
COCO val, printed and written to ``{result_dir}/metrics.json``.
``klab-torch-caption``: caption image files with a trained run.
``klab-torch-convert-hf``: HF ``t5`` and ``swinv2`` model directories -> a
pretrained checkpoint for ``--init_checkpoint``, with the T5 directory's
``tokenizer.json`` / ``spiece.model`` copied beside it (the JAX package's
``tools/convert_hf_checkpoint.py``, with its flags).
``klab-torch-export-hf``: a run's checkpoint -> one HF ``pytorch_model.bin``
per tower and ``vision_projection.bin`` (``tools/export_hf_checkpoint.py``).
``klab-torch-serve``: serve a trained run over HTTP with dynamic batching
(``POST /caption``, ``POST /caption_stream``, ``GET /healthz``,
``GET /stats``), or continuous batching, int8 decode, speculative decode or
one replica per card.

Each also runs as ``python -m klab_multimodalmodel_tpu_torch
{train,eval,caption,convert-hf,export-hf,serve}``. Train, eval, caption and
serve run on the card; ``--device cpu`` (the one flag the JAX package's
commands lack) runs them on the CPU. The converters run on the host.

Train also runs data-parallel under torchrun, one process per card, as the
reference launches it::

    python -m torch.distributed.run --nproc_per_node W \
        -m klab_multimodalmodel_tpu_torch train ...

(``--batch_size`` per data rank), and leaves the process group on exit.
``--mesh_shape D F T [S [P [E]]]`` lays the W ranks out over data, fsdp,
tensor, seq, pipe and expert: with F or T above 1 the model is sharded
(FSDP2 over data x fsdp, tensor parallelism over tensor;
``parallel/partitioning.py``), S splits the positions, P the
transformer's GPipe stages (``--pipeline_stages P``) and E its experts
(``--moe_experts`` a multiple of E). The ranks of a tensor, seq, pipe or
expert group share their rows, so the global batch is ``batch_size`` x D x
F. The other commands are single-process, as in the JAX package, and
refuse a job of several processes.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import time
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .config import Config, build_arg_parser, config_from_args
from .utils.mesh import distributed_env

DEVICE_HELP = "'cuda' (default: the card) or 'cpu'"


def main(argv: Optional[Sequence[str]] = None) -> None:
    """Train: ``parse_arguments``'s flags and ``--device``."""
    from .train.loop import train

    parser = build_arg_parser()
    parser.add_argument("--device", default=None, help=DEVICE_HELP)
    args = parser.parse_args(argv)
    device = args.device
    del args.device
    try:
        train(config_from_args(args), device=device)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _single_process(command: str) -> None:
    """Raise in a job of several processes: ``command`` runs in one."""
    job = distributed_env()
    if job is not None and job.world_size > 1:
        raise RuntimeError(
            f"{command} runs in one process; it was launched as rank "
            f"{job.rank} of {job.world_size} (only train runs under "
            "torchrun)")


def _load_run(result_dir: str, checkpoint: str):
    """(config, tokenizer, model state dict) of a trained run directory:
    its ``config.json`` and the model of ``checkpoints/{checkpoint}``
    (``checkpoint/io.py``'s layout, assembled whole)."""
    from .checkpoint.io import read_whole
    from .text.tokenizer import load_tokenizer

    with open(os.path.join(result_dir, "config.json")) as f:
        config = Config.from_json(f.read())
    tokenizer = load_tokenizer(config.tokenizer_path)
    state = read_whole(os.path.join(os.path.abspath(result_dir),
                                    "checkpoints", checkpoint))
    return config, tokenizer, state


def eval_main(argv: Optional[Sequence[str]] = None) -> None:
    from .evaluation import run

    p = argparse.ArgumentParser(
        description="CIDEr-D / BLEU-1..4 / ROUGE-L caption evaluation over "
                    "COCO val (official PTB tokenization semantics)")
    p.add_argument("--result_dir", required=True)
    p.add_argument("--checkpoint", default="best")
    p.add_argument("--data_dir", default=None)
    p.add_argument("--limit", type=int, default=None,
                   help="evaluate only the first N images")
    p.add_argument("--num_beams", type=int, default=None)
    p.add_argument("--device", default=None, help=DEVICE_HELP)
    args = p.parse_args(argv)
    _single_process("eval")

    config, tokenizer, state = _load_run(args.result_dir, args.checkpoint)
    if args.data_dir:
        config.data_dir = args.data_dir
    if args.num_beams:
        config.num_beams = args.num_beams
    metrics = run(config, state, tokenizer, limit=args.limit,
                  device=args.device)
    print(json.dumps(metrics, indent=2))


def caption_main(argv: Optional[Sequence[str]] = None) -> None:
    from .data.datasets import load_image_resized
    from .infer.captioner import Captioner

    p = argparse.ArgumentParser(
        description="Caption image files with a trained run")
    p.add_argument("images", nargs="+", help="image file paths")
    p.add_argument("--result_dir", required=True)
    p.add_argument("--checkpoint", default="best")
    p.add_argument("--prompt", default=None,
                   help="override the training prompt (an explicitly "
                        "empty string probes promptless decoding)")
    p.add_argument("--max_length", type=int, default=None)
    p.add_argument("--num_beams", type=int, default=None)
    p.add_argument("--min_length", type=int, default=0)
    p.add_argument("--repetition_penalty", type=float, default=1.0)
    p.add_argument("--no_repeat_ngram_size", type=int, default=0)
    p.add_argument("--device", default=None, help=DEVICE_HELP)
    args = p.parse_args(argv)
    _single_process("caption")

    config, tokenizer, state = _load_run(args.result_dir, args.checkpoint)
    captioner = Captioner(config, state, tokenizer, device=args.device)
    images = np.stack([load_image_resized(path, config.swin.image_size)
                       for path in args.images])
    prompts = ([args.prompt] * len(args.images)
               if args.prompt is not None else None)
    captions = captioner.caption(
        images, prompts=prompts, max_length=args.max_length,
        num_beams=args.num_beams, min_length=args.min_length,
        repetition_penalty=args.repetition_penalty,
        no_repeat_ngram_size=args.no_repeat_ngram_size)
    for path, text in zip(args.images, captions):
        print(f"{path}\t{text}")


def _model_name_flags(p: argparse.ArgumentParser) -> None:
    d = Config()
    p.add_argument("--language_model_name", default=d.language_model_name)
    p.add_argument("--transformer_model_name",
                   default=d.transformer_model_name)
    p.add_argument("--image_model_name", default=d.image_model_name)


def _names_config(args: argparse.Namespace) -> Config:
    return Config(language_model_name=args.language_model_name,
                  transformer_model_name=args.transformer_model_name,
                  image_model_name=args.image_model_name)


def convert_hf_main(argv: Optional[Sequence[str]] = None) -> None:
    """HF checkpoints -> ``{output}/checkpoints/pretrained/model.pt``
    (``save_pretrained``): the T5 checkpoint gives both the text tower and
    the transformer. Needs neither ``transformers`` nor ``safetensors``."""
    from .checkpoint.convert_hf import convert_hf_checkpoint
    from .checkpoint.hf_files import load_state_dict
    from .checkpoint.io import MODEL_FILE, save_pretrained

    p = argparse.ArgumentParser(
        description="Convert HF t5 + swinv2 checkpoints (model.safetensors "
                    "or pytorch_model.bin) into a pretrained checkpoint for "
                    "--init_checkpoint")
    p.add_argument("--t5_dir", required=True)
    p.add_argument("--swin_dir", required=True)
    _model_name_flags(p)
    p.add_argument("--output", required=True)
    args = p.parse_args(argv)
    _single_process("convert-hf")
    cfg = _names_config(args)

    t0 = time.perf_counter()
    t5_sd = load_state_dict(args.t5_dir)
    swin_sd = load_state_dict(args.swin_dir)
    read_s = time.perf_counter() - t0
    state = convert_hf_checkpoint(t5_sd, swin_sd, cfg)
    t0 = time.perf_counter()
    out = os.path.abspath(args.output)
    path = os.path.join(save_pretrained(out, state), MODEL_FILE)
    write_s = time.perf_counter() - t0
    for name in ("tokenizer.json", "spiece.model"):
        src = os.path.join(args.t5_dir, name)
        if os.path.exists(src):
            shutil.copy(src, os.path.join(out, name))
    n = sum(v.numel() for v in state.values())
    read_gb = sum(v.numel() * v.element_size() for sd in (t5_sd, swin_sd)
                  for v in sd.values()) / 1e9
    print(f"wrote {path} ({n:,} params, {os.path.getsize(path) / 1e9:.3f} "
          f"GB in {write_s:.2f} s; read {read_gb:.3f} GB in {read_s:.2f} s)")


def export_hf_main(argv: Optional[Sequence[str]] = None) -> None:
    """A run's ``checkpoints/{checkpoint}`` (its model, assembled whole
    from its pieces) -> HF state dicts:
    ``{output}/{transformer,language_model,image_model}/pytorch_model.bin``
    and ``{output}/vision_projection.bin``."""
    from .checkpoint.export_hf import (export_swinv2, export_t5_encoder,
                                       export_t5_lm, split_towers)
    from .checkpoint.io import read_whole

    p = argparse.ArgumentParser(
        description="Export a checkpoint's towers as HF state dicts")
    p.add_argument("--result_dir", required=True)
    p.add_argument("--checkpoint", default="best")
    _model_name_flags(p)
    p.add_argument("--output", required=True)
    args = p.parse_args(argv)
    _single_process("export-hf")
    cfg = _names_config(args)

    state = read_whole(os.path.join(os.path.abspath(args.result_dir),
                                    "checkpoints", args.checkpoint))
    towers = split_towers(state)
    exports = {
        "transformer": export_t5_lm(towers["transformer"],
                                    cfg.transformer_t5),
        "language_model": export_t5_encoder(towers["language_model"],
                                            cfg.language_t5),
        "image_model": export_swinv2(towers["image_model"], cfg.swin),
    }
    out = os.path.abspath(args.output)
    for tower, sd in exports.items():
        tower_dir = os.path.join(out, tower)
        os.makedirs(tower_dir, exist_ok=True)
        torch.save(sd, os.path.join(tower_dir, "pytorch_model.bin"))
        print(f"wrote {tower_dir}/pytorch_model.bin ({len(sd)} tensors)")
    if "vision_projection" in towers:
        torch.save({"weight": towers["vision_projection"]["weight"].to(
            torch.float32)}, os.path.join(out, "vision_projection.bin"))
        print(f"wrote {out}/vision_projection.bin")


def serve_parser() -> argparse.ArgumentParser:
    """``klab-torch-serve``'s flags: the JAX ``klab-serve``'s and
    ``--device``."""
    p = argparse.ArgumentParser(
        description="Serve a trained run over HTTP with dynamic batching "
                    "(POST /caption, streaming POST /caption_stream, "
                    "GET /healthz, GET /stats)")
    p.add_argument("--result_dir", required=True)
    p.add_argument("--checkpoint", default="best")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--max_batch", type=int, default=8,
                   help="largest coalesced batch; requests pad to "
                        "power-of-two buckets up to this")
    p.add_argument("--batch_window_ms", type=float, default=5.0,
                   help="how long the first queued request waits for "
                        "companions before its batch dispatches")
    p.add_argument("--no_warmup", action="store_true",
                   help="skip running the batch buckets before reporting "
                        "healthy (first requests then pay the set-up)")
    p.add_argument("--int8", action="store_true",
                   help="int8 weight-only decode (infer/quantize.py); the "
                        "encoders keep full precision")
    p.add_argument("--speculative_draft", type=int, default=0,
                   help="prompt-lookup speculative decoding with draft "
                        "length K for plain-greedy requests "
                        "(infer/speculative.py; greedy's tokens, fewer "
                        "decoder passes when drafts are accepted); 0 off")
    p.add_argument("--max_gen_length", type=int, default=128,
                   help="upper bound on per-request max_length (the "
                        "cache's size)")
    p.add_argument("--stream_chunk", type=int, default=4,
                   help="default tokens per /caption_stream SSE event "
                        "(clients may override with chunk_size)")
    p.add_argument("--replicas", type=int, default=1,
                   help="serve N replicas, one per card, least-loaded "
                        "routing")
    p.add_argument("--continuous", action="store_true",
                   help="continuous batching for the greedy default path "
                        "(serve/continuous.py): a resident decode batch "
                        "that requests join and leave mid-flight; beams "
                        "and sampling fall back to the dynamic batcher")
    p.add_argument("--slots", type=int, default=16,
                   help="resident decode-batch rows for --continuous")
    p.add_argument("--engine_chunk", type=int, default=4,
                   help="decode steps between admission/reap boundaries "
                        "for --continuous")
    p.add_argument("--device", default=None, help=DEVICE_HELP)
    return p


def serve_main(argv: Optional[Sequence[str]] = None) -> None:
    """Serve until SIGTERM (which drains: the accept loop stops and the
    service closes) or Ctrl-C."""
    import signal
    import threading

    from .serve.service import batch_buckets
    from .serve.http import CaptionHTTPServer
    from .utils.device import resolve_device

    p = serve_parser()
    args = p.parse_args(argv)
    _single_process("serve")
    if args.speculative_draft < 0:
        p.error(f"--speculative_draft must be >= 0, got "
                f"{args.speculative_draft}")
    if args.continuous and args.replicas > 1:
        raise SystemExit("--continuous with --replicas is not supported "
                         "yet; pick one scale-out mode")
    if args.continuous and args.speculative_draft:
        raise SystemExit("--continuous with --speculative_draft is not "
                         "supported: the engine decodes one token per slot "
                         "per pass, so the drafts would serve only the "
                         "fallback's requests; pick one")
    device = resolve_device(args.device)
    if args.replicas > 1:
        devices = ([torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())]
                   if device.type == "cuda" else [device])
        if args.replicas > len(devices):
            raise SystemExit(f"--replicas {args.replicas} > "
                             f"{len(devices)} visible devices")

    config, tokenizer, state = _load_run(args.result_dir, args.checkpoint)
    service_kw = dict(max_batch=args.max_batch,
                      window_ms=args.batch_window_ms,
                      decode_int8=args.int8,
                      max_gen_length=args.max_gen_length,
                      stream_chunk=args.stream_chunk,
                      speculative_draft=args.speculative_draft)
    if args.replicas > 1:
        from .serve.replicas import ReplicatedCaptionService

        service = ReplicatedCaptionService(
            config, state, tokenizer, devices[:args.replicas], **service_kw)
    elif args.continuous:
        from .serve.continuous import ContinuousCaptionService

        service = ContinuousCaptionService(
            config, state, tokenizer, slots=args.slots,
            engine_chunk=args.engine_chunk, device=device, **service_kw)
    else:
        from .serve.service import CaptionService

        service = CaptionService(config, state, tokenizer, device=device,
                                 **service_kw)
    del state
    server = CaptionHTTPServer(service, host=args.host, port=args.port)
    n_buckets = 0 if args.no_warmup else len(batch_buckets(args.max_batch))
    print(f"klab-torch-serve: listening on {args.host}:{server.port} "
          f"(warming {n_buckets} buckets)", flush=True)
    halt = threading.Event()
    try:
        signal.signal(signal.SIGTERM, lambda *_: halt.set())
    except ValueError:
        pass  # not the main thread: Ctrl-C only
    server.start(warmup=not args.no_warmup)
    print("klab-torch-serve: ready", flush=True)
    try:
        halt.wait()
        print("klab-torch-serve: SIGTERM, draining", flush=True)
    except KeyboardInterrupt:
        pass
    server.stop()

if __name__ == "__main__":
    main()
