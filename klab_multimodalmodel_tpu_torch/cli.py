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

Each also runs as ``python -m klab_multimodalmodel_tpu_torch
{train,eval,caption,convert-hf,export-hf}``. Train, eval and caption run on
the card; ``--device cpu`` (the one flag the JAX package's commands lack)
runs them on the CPU. The converters run on the host.
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

from .config import Config, build_arg_parser, config_from_args

DEVICE_HELP = "'cuda' (default: the card) or 'cpu'"


def main(argv: Optional[Sequence[str]] = None) -> None:
    """Train: ``parse_arguments``'s flags and ``--device``."""
    from .train.loop import train

    parser = build_arg_parser()
    parser.add_argument("--device", default=None, help=DEVICE_HELP)
    args = parser.parse_args(argv)
    device = args.device
    del args.device
    train(config_from_args(args), device=device)


def _load_run(result_dir: str, checkpoint: str):
    """(config, tokenizer, model state dict) of a trained run directory:
    its ``config.json`` and the model of ``checkpoints/{checkpoint}``
    (``checkpoint/io.py``'s layout)."""
    from .checkpoint.io import MODEL_FILE
    from .text.tokenizer import load_tokenizer

    with open(os.path.join(result_dir, "config.json")) as f:
        config = Config.from_json(f.read())
    tokenizer = load_tokenizer(config.tokenizer_path)
    path = os.path.join(os.path.abspath(result_dir), "checkpoints",
                        checkpoint, MODEL_FILE)
    state = torch.load(path, map_location="cpu", weights_only=True)
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
    """A run's ``checkpoints/{checkpoint}/model.pt`` -> HF state dicts:
    ``{output}/{transformer,language_model,image_model}/pytorch_model.bin``
    and ``{output}/vision_projection.bin``."""
    from .checkpoint.export_hf import (export_swinv2, export_t5_encoder,
                                       export_t5_lm, split_towers)
    from .checkpoint.io import MODEL_FILE

    p = argparse.ArgumentParser(
        description="Export a checkpoint's towers as HF state dicts")
    p.add_argument("--result_dir", required=True)
    p.add_argument("--checkpoint", default="best")
    _model_name_flags(p)
    p.add_argument("--output", required=True)
    args = p.parse_args(argv)
    cfg = _names_config(args)

    path = os.path.join(os.path.abspath(args.result_dir), "checkpoints",
                        args.checkpoint, MODEL_FILE)
    state = torch.load(path, map_location="cpu", weights_only=True)
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


def serve_main(argv: Optional[Sequence[str]] = None) -> None:
    raise NotImplementedError(
        "serving (HTTP, dynamic and continuous batching, replicas) is not "
        "ported (ROADMAP A10)")


if __name__ == "__main__":
    main()
