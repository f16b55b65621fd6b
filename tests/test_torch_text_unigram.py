"""The port's ``UnigramTokenizer`` against the JAX package's (which wraps HF
``tokenizers``): ids, masks, decoded strings, the vocabulary's attributes
and the load errors, exactly, on every tokenizer file layout the port
reads, all written in ``tmp_path``:

- ``trained``: a ``tokenizer.json`` from the JAX ``train_unigram_tokenizer``
  (no normalizer, Metaspace);
- ``spm`` / ``spm_charsmap``: synthetic T5-layout ``spiece.model`` protos,
  without and with a precompiled charsmap (written through
  ``transformers``' protobuf module, as ``tests/test_native.py`` does);
- ``spm_json``: HF's T5 conversion of ``spm_charsmap`` saved as
  ``tokenizer.json`` (Precompiled, Strip, Replace; Metaspace);
- ``whitespace_json``: the older T5 ``tokenizer.json`` layout (Precompiled;
  WhitespaceSplit then a legacy Metaspace with ``add_prefix_space``);
- ``no_sentinels`` / ``partial_sentinels``: vocabularies with no and with
  ten ``<extra_id_k>`` tokens.

And ``load_tokenizer`` on both file types in an interpreter where
``tokenizers``, ``sentencepiece``, ``transformers`` and ``PIL`` cannot be
imported, as on the card's machine.
"""

import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from klab_multimodalmodel_tpu.text import tokenizer as jtok
from klab_multimodalmodel_tpu.text.charsmap import build_charsmap
from klab_multimodalmodel_tpu_torch.native import NativeUnigramEncoder
from klab_multimodalmodel_tpu_torch.text import tokenizer as ttok

ROOT = pathlib.Path(__file__).resolve().parent.parent

TRAIN_TEXTS = [
    "a man rides a moped down the road", "a dog jumps over the fence",
    "the cat sits on the mat", "café résumé naïve façade",
    "What does th image describe ?", "two people on a beach at sunset",
] * 40

CORPUS = [
    "What does th image describe ?", "a cat", "the dog .",
    # accents, combining marks (e + U+0301), full-width, ligatures
    "caf\u00e9", "cafe\u0301 au lait", "e\u0301\u0301x", "Ａ cat", "x①y",
    "ﬁle", "¼ cup", "a　b", "héllo wörld",
    # whitespace: runs of spaces, leading and trailing, tabs and newlines
    "a  b", "a   b  c", "  a", "a ", " ", "", "\t", "a\tb", "a\nb", " \n a ",
    # sentinels inside the text, and special tokens' text
    "<extra_id_0> cat", "a <extra_id_0> b <extra_id_1>", "a<extra_id_0>b",
    "the cat <extra_id_0>", "dog  <extra_id_1>  cat", "<extra_id_99>",
    "x </s> y <pad>", "<unk>",
    # characters outside the vocabulary, a literal metaspace
    "ZZZ", "aZZb", "Z", "日本語 text", "▁x", "th e", "x▁y",
]

SPM_WORDS = ["▁a", "▁b", "▁cat", "▁dog", "▁the", "▁fi", "▁le", "le", "▁1",
             "/4", "1", "4", "▁A", "A", "a", "b", "c", "t", "d", "o", "g",
             "e", "h", "i", "s", "▁", "file", "▁what", "▁does", "th",
             "▁image", "▁describe", "?", "▁?", ".", "x▁y", "é", "r", "n",
             "u", "l", "p", "▁c", "af", "W", "ha", "▁W", "▁x", "y", "x"]
CHARSMAP = {"Ａ": "A", "①": "1", "　": " ", "ﬁ": "fi", "¼": " 1/4",
            "\u00e9": "e", "e\u0301": "\u00e9"}


def write_spm(path, charsmap=b"", model_type=1, words=SPM_WORDS):
    from transformers.convert_slow_tokenizer import import_protobuf

    pb2 = import_protobuf()
    m = pb2.ModelProto()
    m.trainer_spec.model_type = model_type
    m.trainer_spec.unk_id = 2
    m.trainer_spec.byte_fallback = False
    m.normalizer_spec.precompiled_charsmap = charsmap
    kinds = pb2.ModelProto.SentencePiece
    for text, score, kind in [("<pad>", 0.0, kinds.CONTROL),
                              ("</s>", 0.0, kinds.CONTROL),
                              ("<unk>", 0.0, kinds.UNKNOWN)] + [
            (w, -1.0 - 0.1 * i, kinds.NORMAL) for i, w in enumerate(words)]:
        p = m.pieces.add()
        p.piece, p.score, p.type = text, score, kind
    with open(path, "wb") as f:
        f.write(m.SerializeToString())
    return str(path)


def _trained_without_sentinels(path, sentinels: int):
    from tokenizers import (Tokenizer, decoders, models, pre_tokenizers,
                            trainers)

    tok = Tokenizer(models.Unigram())
    tok.pre_tokenizer = pre_tokenizers.Metaspace()
    tok.decoder = decoders.Metaspace()
    tok.train_from_iterator(TRAIN_TEXTS, trainers.UnigramTrainer(
        vocab_size=120, special_tokens=["<pad>", "</s>", "<unk>"],
        unk_token="<unk>"))
    if sentinels:
        tok.add_special_tokens(
            [f"<extra_id_{k}>" for k in reversed(range(sentinels))])
    tok.save(str(path))
    return str(path)


def _whitespace_json(spm_path, path):
    """The older T5 tokenizer.json layout: the Precompiled normalizer alone,
    then WhitespaceSplit and a Metaspace written with add_prefix_space."""
    from tokenizers import normalizers, pre_tokenizers

    tok = jtok._tokenizer_from_spm(spm_path)
    tok.normalizer = normalizers.Precompiled(build_charsmap(CHARSMAP))
    tok.pre_tokenizer = pre_tokenizers.Sequence(
        [pre_tokenizers.WhitespaceSplit(), pre_tokenizers.Metaspace()])
    tok.save(str(path))
    spec = json.load(open(path))
    for entry in (spec["pre_tokenizer"]["pretokenizers"][1],
                  spec["decoder"]):
        del entry["prepend_scheme"], entry["split"]
        entry["add_prefix_space"] = True
    with open(path, "w") as f:
        json.dump(spec, f)
    return str(path)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("tokenizers")
    out = {"trained": str(d / "trained.json")}
    jtok.train_unigram_tokenizer(TRAIN_TEXTS, out["trained"], vocab_size=400)
    out["spm"] = write_spm(d / "plain.model")
    out["spm_charsmap"] = write_spm(d / "charsmap.model",
                                    build_charsmap(CHARSMAP))
    out["spm_json"] = str(d / "spm.json")
    jtok._tokenizer_from_spm(out["spm_charsmap"]).save(out["spm_json"])
    out["whitespace_json"] = _whitespace_json(out["spm"],
                                              d / "whitespace.json")
    out["no_sentinels"] = _trained_without_sentinels(d / "none.json", 0)
    out["partial_sentinels"] = _trained_without_sentinels(
        d / "partial.json", 10)
    return out


KINDS = ["trained", "spm", "spm_charsmap", "spm_json", "whitespace_json",
         "no_sentinels", "partial_sentinels"]


@pytest.fixture(scope="module")
def pairs(files):
    return {k: (jtok.UnigramTokenizer(p), ttok.load_tokenizer(p))
            for k, p in files.items()}


@pytest.mark.parametrize("kind", KINDS)
def test_ids_match_jax(pairs, kind):
    jax_tok, tok = pairs[kind]
    assert isinstance(tok, ttok.UnigramTokenizer)
    for text in CORPUS:
        assert tok.encode_ids(text) == jax_tok.encode_ids(text), repr(text)
    for max_length in (4, 24):
        want, got = jax_tok(CORPUS, max_length), tok(CORPUS, max_length)
        np.testing.assert_array_equal(got.input_ids, want.input_ids)
        np.testing.assert_array_equal(got.attention_mask,
                                      want.attention_mask)


@pytest.mark.parametrize("kind", KINDS)
def test_decode_matches_jax(pairs, kind):
    """The corpus's ids, and seeded random id rows over the whole
    vocabulary (special tokens included), decode to the same strings with
    and without ``skip_special_tokens``."""
    jax_tok, tok = pairs[kind]
    rng = np.random.default_rng(0)
    rows = [jax_tok.encode_ids(t) for t in CORPUS]
    rows += [rng.integers(0, tok.vocab_size, int(rng.integers(1, 12))
                          ).tolist() for _ in range(200)]
    for skip in (True, False):
        assert tok.batch_decode(rows, skip) == jax_tok.batch_decode(
            rows, skip)


@pytest.mark.parametrize("kind", KINDS)
def test_vocabulary_matches_jax(pairs, kind):
    jax_tok, tok = pairs[kind]
    for name in ("vocab_size", "pad_id", "eos_id", "unk_id",
                 "num_sentinels"):
        assert getattr(tok, name) == getattr(jax_tok, name), name
    assert tok.num_sentinels == {"no_sentinels": 0,
                                 "partial_sentinels": 10}.get(kind, 100)


@pytest.mark.parametrize("kind", ["trained", "spm_charsmap",
                                  "whitespace_json"])
def test_encode_batch_equals_call(pairs, files, kind):
    """``__call__``'s one C++ call (``encode_batch``, on the caller's thread
    for a short batch, on several for a long one or when asked) gives the
    ids and masks of the text-at-a-time path, NULs, truncation and padding
    included."""
    _, tok = pairs[kind]
    enc = NativeUnigramEncoder(files[kind])
    texts = CORPUS * 3
    long = [t * 40 for t in CORPUS] * 10  # > 2 KiB: threads
    for batch in (texts, long):
        for max_length in (1, 5, 32):
            want = ttok.TokenizerBase.__call__(tok, batch, max_length)
            for got in (tok(batch, max_length),
                        dict(zip(("input_ids", "attention_mask"),
                                 enc.encode_batch(batch, max_length,
                                                  tok.pad_id, tok.eos_id,
                                                  n_threads=3)))):
                np.testing.assert_array_equal(got["input_ids"],
                                              want.input_ids)
                np.testing.assert_array_equal(got["attention_mask"],
                                              want.attention_mask)


def test_misplaced_sentinel_raises_as_jax(tmp_path):
    from tokenizers import Tokenizer

    path = _trained_without_sentinels(tmp_path / "bad.json", 0)
    tok = Tokenizer.from_file(path)
    tok.add_special_tokens(["<extra_id_0>", "<extra_id_1>"])  # 0 not last
    tok.save(path)
    for cls in (jtok.UnigramTokenizer, ttok.UnigramTokenizer):
        with pytest.raises(ValueError, match="must be the last vocab id"):
            cls(path)


def test_non_unigram_spm_raises_as_jax(tmp_path):
    path = write_spm(tmp_path / "bpe.model", model_type=2)
    for cls in (jtok.UnigramTokenizer, ttok.UnigramTokenizer):
        with pytest.raises(ValueError, match="only unigram"):
            cls(path)


def test_missing_specials_raise_as_jax(tmp_path):
    path = write_spm(tmp_path / "nopad.model")
    spec = jtok._tokenizer_from_spm(path)
    spec.save(str(tmp_path / "nopad.json"))
    data = json.load(open(tmp_path / "nopad.json"))
    data["model"]["vocab"][0][0] = "<padding>"
    with open(tmp_path / "nopad.json", "w") as f:
        json.dump(data, f)
    for cls in (jtok.UnigramTokenizer, ttok.UnigramTokenizer):
        with pytest.raises(ValueError, match="missing <pad>"):
            cls(str(tmp_path / "nopad.json"))


@pytest.mark.parametrize("edit,match", [
    (lambda s: s["model"].update(type="BPE"), "only Unigram"),
    (lambda s: s["pre_tokenizer"].update(prepend_scheme="first"),
     "pre-tokenizer"),
    (lambda s: s.update(normalizer={"type": "Lowercase"}), "normalizer"),
    (lambda s: s["added_tokens"][-1].update(normalized=True),
     "added token"),
])
def test_unsupported_json_raises(files, tmp_path, edit, match):
    """A step the C++ core does not have raises, rather than encode
    otherwise than HF tokenizers would."""
    spec = json.load(open(files["trained"]))
    edit(spec)
    path = tmp_path / "edited.json"
    with open(path, "w") as f:
        json.dump(spec, f)
    with pytest.raises(ValueError, match=match):
        ttok.load_tokenizer(str(path))


def test_train_unigram_tokenizer_matches_jax_and_needs_tokenizers(
        tmp_path, monkeypatch):
    """The port's trainer writes the JAX trainer's layout (the trainer
    itself runs on threads, so two runs need not pick the same pieces):
    the JAX tokenizer reads the file and gives the port's ids."""
    texts = TRAIN_TEXTS[:12] * 10
    tok = ttok.train_unigram_tokenizer(texts, str(tmp_path / "t.json"), 300)
    jax_tok = jtok.UnigramTokenizer(str(tmp_path / "t.json"))
    assert (tok.vocab_size, tok.num_sentinels) == (jax_tok.vocab_size, 100)
    assert [tok.encode_ids(t) for t in CORPUS] == [
        jax_tok.encode_ids(t) for t in CORPUS]
    monkeypatch.setitem(sys.modules, "tokenizers", None)
    with pytest.raises(ImportError, match="needs the HF 'tokenizers'"):
        ttok.train_unigram_tokenizer(texts, str(tmp_path / "u.json"), 300)


def test_load_tokenizer_without_hf_packages(files, pairs):
    """Both file types load, encode and decode where ``tokenizers``,
    ``sentencepiece``, ``transformers`` and ``PIL`` cannot be imported."""
    code = (
        "import json, sys\n"
        "for name in ('tokenizers', 'sentencepiece', 'transformers', "
        "'PIL', 'jax', 'klab_multimodalmodel_tpu'):\n"
        "    sys.modules[name] = None\n"
        "from klab_multimodalmodel_tpu_torch.text import load_tokenizer\n"
        f"corpus = {CORPUS!r}\n"
        "out = {}\n"
        f"for kind, path in {dict(files)!r}.items():\n"
        "    tok = load_tokenizer(path)\n"
        "    ids = [tok.encode_ids(t) for t in corpus]\n"
        "    out[kind] = [ids, tok.batch_decode(ids, False)]\n"
        "print(json.dumps(out))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout)
    assert set(got) == {"trained", "spm", "spm_charsmap", "spm_json",
                        "whitespace_json", "no_sentinels",
                        "partial_sentinels"}
    for kind, (ids, texts) in got.items():
        jax_tok = pairs[kind][0]
        want = [jax_tok.encode_ids(t) for t in CORPUS]
        assert ids == want, kind
        assert texts == jax_tok.batch_decode(want, False), kind
