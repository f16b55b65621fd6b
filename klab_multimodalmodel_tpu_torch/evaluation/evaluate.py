"""Caption evaluation: a trained model -> captions -> CIDEr-D/BLEU/ROUGE-L.

Captions a COCO-style val set in batches, with every reference caption per
image, and reports CIDEr-D, the cumulative BLEU-1..4 tuple and ROUGE-L
(``metrics.py``); ``run`` writes them to ``{result_dir}/metrics.json``.
"""

from __future__ import annotations

import json
import os
from typing import Mapping, Optional, Sequence, Union

import numpy as np
import torch

from ..config import Config
from ..data.coco import CocoIndex
from ..data.datasets import COCO_PROMPT, load_image_resized
from ..infer.captioner import Captioner
from ..models.multimodal import MultiModalModel
from ..text.tokenizer import TokenizerBase
from .metrics import bleu_n, cider_d, rouge_l


def coco_references(data_dir: str, phase: str = "val"
                    ) -> tuple[list[str], list[list[str]]]:
    """(image paths, all captions per image): unlike training, which uses
    only the first caption, evaluation uses every reference."""
    anno = os.path.join(data_dir, "annotations",
                        f"captions_{phase}2017.json")
    coco = CocoIndex(anno)
    img_dir = os.path.join(data_dir, f"{phase}2017")
    paths, refs = [], []
    for image_id in coco.getImgIds():
        info = coco.loadImgs(image_id)[0]
        anns = coco.loadAnns(coco.getAnnIds(image_id))
        if not anns:
            continue
        paths.append(os.path.join(img_dir, info["file_name"]))
        refs.append([a["caption"] for a in anns])
    return paths, refs


def evaluate_captions(config: Config,
                      params: Union[Mapping[str, torch.Tensor],
                                    MultiModalModel],
                      tokenizer: TokenizerBase, paths: Sequence[str],
                      references: Sequence[Sequence[str]],
                      batch_size: int = 32, limit: Optional[int] = None,
                      num_beams: Optional[int] = None,
                      device=None) -> dict:
    """Caption ``paths`` (the first ``limit``) and score them against
    ``references``. ``params``: a state dict or a ``MultiModalModel`` on
    ``device`` (``Captioner``'s argument); ``device``: None means the card.

    Keeps the JAX package's pipeline: batch N is launched before batch
    N - 1's ids are read back and detokenized, and batch N + 1's images are
    decoded after. The port's decode loop reads a flag back every pass, so a
    launch returns when its decoding is done: the host's JPEG decode and
    the device's work do not overlap here. The ragged tail is padded with
    black images to ``batch_size`` rows."""
    captioner = Captioner(config, params, tokenizer, device=device)
    if limit:
        paths = paths[:limit]
        references = references[:limit]
    size = config.swin.image_size
    predictions: list[str] = []
    pending: Optional[tuple] = None
    for i in range(0, len(paths), batch_size):
        chunk = paths[i:i + batch_size]
        pad = batch_size - len(chunk)
        imgs = np.stack([load_image_resized(p, size) for p in chunk]
                        + [np.zeros((size, size, 3), np.uint8)] * pad)
        ids = captioner.caption_launch(imgs, [COCO_PROMPT] * batch_size,
                                       num_beams=num_beams)
        if pending is not None:
            predictions.extend(
                captioner.caption_finish(pending[0])[:pending[1]])
        pending = (ids, len(chunk))
    if pending is not None:
        predictions.extend(captioner.caption_finish(pending[0])[:pending[1]])
    refs = list(references)
    bleus = bleu_n(predictions, refs)
    return {
        "num_images": len(paths),
        "CIDEr-D": cider_d(predictions, refs),
        "BLEU-1": bleus[0], "BLEU-2": bleus[1],
        "BLEU-3": bleus[2], "BLEU-4": bleus[3],
        "ROUGE-L": rouge_l(predictions, refs),
        "sample": {"prediction": predictions[0],
                   "references": list(refs[0])} if predictions else {},
    }


def run(config: Config, params, tokenizer: TokenizerBase,
        limit: Optional[int] = None, device=None) -> dict:
    """Evaluate on ``{data_dir}`` COCO val with ``config.num_beams`` and
    write the metrics to ``{result_dir}/metrics.json``."""
    paths, refs = coco_references(config.data_dir, "val")
    metrics = evaluate_captions(config, params, tokenizer, paths, refs,
                                limit=limit, num_beams=config.num_beams,
                                device=device)
    out = os.path.join(config.result_dir, "metrics.json")
    os.makedirs(config.result_dir, exist_ok=True)
    with open(out, "w") as f:
        json.dump(metrics, f, indent=2)
    return metrics
