"""Console entry points of the port, with the JAX package's flags.

``klab-torch-train``: train (``config.build_arg_parser``'s flags).
``klab-torch-eval``: CIDEr-D / BLEU-1..4 / ROUGE-L of a trained run over
COCO val, printed and written to ``{result_dir}/metrics.json``.
``klab-torch-caption``: caption image files with a trained run.

Each also runs as ``python -m klab_multimodalmodel_tpu_torch
{train,eval,caption}``. They run on the card; ``--device cpu`` (the one flag
the JAX package's commands lack) runs them on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
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


def serve_main(argv: Optional[Sequence[str]] = None) -> None:
    raise NotImplementedError(
        "serving (HTTP, dynamic and continuous batching, replicas) is not "
        "ported (ROADMAP A10)")


if __name__ == "__main__":
    main()
