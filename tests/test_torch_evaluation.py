"""The port's caption evaluation against the JAX package's: the metrics as
floats, exactly, on a fixed corpus and on PTB edge strings; COCO references;
``evaluate_captions`` on the same weights and JPEGs (same predictions, same
metrics); ``run`` writing ``metrics.json``.

Image decode: both sides through Pillow, then each package's C++ bicubic
resize (the port's is a copy of the JAX package's, bitwise equal, as in
``tests/test_torch_data.py``)."""

import dataclasses
import json
import os

import numpy as np
import pytest

import _torch_port as tp
import klab_multimodalmodel_tpu.evaluation as jeval
from klab_multimodalmodel_tpu.ops import set_interpret
from klab_multimodalmodel_tpu.text import ByteTokenizer as JByteTokenizer
from klab_multimodalmodel_tpu_torch import evaluation as teval
from klab_multimodalmodel_tpu_torch.checkpoint.from_jax import (
    convert_jax_params)
from klab_multimodalmodel_tpu_torch.evaluation import metrics as tmetrics
from klab_multimodalmodel_tpu_torch.text import ByteTokenizer

# The PTB strings of tests/test_evaluation.py, brackets, quotes,
# contractions, ellipses and dashes.
PTB_STRINGS = [
    "A man's dog.", "They'll save and invest more.",
    "I can't swim; he cannot either!", "Good muffins cost $3.88 in New York.",
    'He said, "hi (there)" to the U.S. crowd...',
    "a dog {brown} [spotted]", "a red--blue sign: nice?",
    "A man with a red helmet on a small moped on a dirt road.",
    "hi, my name can't hello,", 'He said, "There is a cat." Really?',
    "two dogs -- one black, one white -- run; they're fast!",
    "the dog's bone (a big one) ...", "A man, with a RED helmet!", "",
]

CANDIDATES = [
    "a dog jumps over the fence", "a cat sleeps on a chair",
    "two boats in the harbor", "children play football in a park",
    "a plate of pasta", "a man rides a red moped down the road", "",
    "the the the the",
]
REFERENCES = [
    ["a dog jumps over the fence", "the dog leaps over a fence"],
    ["a cat sleeps on a warm chair", "a kitten naps on a chair."],
    ["two boats float in the harbor"],
    ["children play football in the park", "kids playing soccer (outside)"],
    ["a plate of pasta on a table", "spaghetti on a white plate",
     "a dish of noodles"],
    ["a man rides a red moped down the road"],
    ["an empty street at night"],
    ["the cat is on the mat", "there is a cat on the mat"],
]


def test_tokenizers_match_jax():
    for text in PTB_STRINGS:
        assert tmetrics.ptb_tokenize(text) == jeval.ptb_tokenize(text), text
        assert (tmetrics.simple_tokenize(text)
                == jeval.simple_tokenize(text)), text


@pytest.mark.parametrize("tokenizer", ["ptb", "simple"])
def test_metrics_match_jax_exactly(tokenizer):
    tk = {"ptb": (tmetrics.ptb_tokenize, jeval.ptb_tokenize),
          "simple": (tmetrics.simple_tokenize, jeval.simple_tokenize)}
    ttok, jtok = tk[tokenizer]
    corpora = [(CANDIDATES, REFERENCES),
               (PTB_STRINGS, [[s, s.upper(), "a dog"] for s in PTB_STRINGS])]
    for cands, refs in corpora:
        assert (teval.cider_d(cands, refs, tokenizer=ttok)
                == jeval.cider_d(cands, refs, tokenizer=jtok))
        assert (teval.bleu_n(cands, refs, tokenizer=ttok)
                == jeval.bleu_n(cands, refs, tokenizer=jtok))
        assert (teval.bleu(cands, refs, max_n=2, tokenizer=ttok)
                == jeval.bleu(cands, refs, max_n=2, tokenizer=jtok))
        assert (teval.rouge_l(cands, refs, tokenizer=ttok)
                == jeval.rouge_l(cands, refs, tokenizer=jtok))
    assert teval.cider_d(CANDIDATES[:1], REFERENCES[:1]) == 0.0  # one image
    with pytest.raises(ValueError, match="reference sets"):
        teval.rouge_l(CANDIDATES, REFERENCES[:2])


@pytest.fixture
def coco_val(tmp_path):
    """COCO val layout: five JPEGs of seeded noise, one to three captions
    each, and an image without a caption."""
    from PIL import Image

    d = tmp_path / "coco"
    (d / "annotations").mkdir(parents=True)
    (d / "val2017").mkdir()
    rng = np.random.default_rng(0)
    images, annotations = [], []
    for i in range(6):
        name = f"{i:012d}.jpg"
        Image.fromarray(rng.integers(0, 256, (40, 52, 3), dtype=np.uint8)
                        ).save(d / "val2017" / name)
        images.append({"id": 10 + i, "file_name": name})
        for j in range(i % 3 + 1 if i < 5 else 0):
            annotations.append({"id": 100 + 10 * i + j, "image_id": 10 + i,
                                "caption": REFERENCES[i][j % len(
                                    REFERENCES[i])]})
    with open(d / "annotations" / "captions_val2017.json", "w") as f:
        json.dump({"images": images, "annotations": annotations}, f)
    return str(d)


@pytest.fixture(scope="module")
def weights():
    jcfg, tcfg = tp.configs("v10", generate_max_length=10)
    params = tp.jax_multimodal_params(jcfg, seed=2)
    return jcfg, tcfg, params


@pytest.mark.parametrize("num_beams", [1, 2])
def test_evaluate_captions_matches_jax(coco_val, weights, num_beams):
    """Five images at batch 2 (a ragged tail of one), the same
    predictions and the same metric floats."""
    jcfg, tcfg, params = weights
    paths, refs = teval.coco_references(coco_val)
    assert (paths, refs) == jeval.coco_references(coco_val)
    assert len(paths) == 5 and [len(r) for r in refs] == [1, 2, 3, 1, 2]
    set_interpret(True)
    try:
        want = jeval.evaluate_captions(jcfg, params, JByteTokenizer(), paths,
                                       refs, batch_size=2,
                                       num_beams=num_beams)
    finally:
        set_interpret(False)
    got = teval.evaluate_captions(tcfg, convert_jax_params(params, tcfg),
                                  ByteTokenizer(), paths, refs, batch_size=2,
                                  num_beams=num_beams, device="cpu")
    assert got == want
    assert got["num_images"] == 5 and got["sample"]["prediction"]
    limited = teval.evaluate_captions(
        tcfg, convert_jax_params(params, tcfg), ByteTokenizer(), paths, refs,
        batch_size=2, limit=3, num_beams=num_beams, device="cpu")
    assert limited["num_images"] == 3
    assert limited["sample"] == got["sample"]


def test_run_writes_metrics_json(coco_val, weights, tmp_path):
    _, tcfg, params = weights
    tcfg = dataclasses.replace(tcfg, data_dir=coco_val, num_beams=2,
                               result_dir=str(tmp_path / "run"))
    metrics = teval.run(tcfg, convert_jax_params(params, tcfg),
                        ByteTokenizer(), limit=4, device="cpu")
    with open(os.path.join(tcfg.result_dir, "metrics.json")) as f:
        assert json.load(f) == metrics
    assert metrics["num_images"] == 4
    for key in ("CIDEr-D", "BLEU-1", "BLEU-2", "BLEU-3", "BLEU-4",
                "ROUGE-L"):
        assert np.isfinite(metrics[key]), key
