"""Streaming decode in the port: the chunks of ``stream_decode`` concatenate
to exactly the monolithic loops' tokens (greedy at chunks 1, 3, 5 and 20;
sampling from the same generator state), every yield is a prefix of the
final tokens, and ``Captioner.caption_stream`` ends on ``caption``'s texts.
Also the captioner's fp32 compute on a model built in another dtype."""

import numpy as np
import pytest
import torch

import _torch_port as tp
from klab_multimodalmodel_tpu_torch.config import T5Size
from klab_multimodalmodel_tpu_torch.infer import generate as tgen
from klab_multimodalmodel_tpu_torch.infer.captioner import Captioner
from klab_multimodalmodel_tpu_torch.models import t5 as tt5
from klab_multimodalmodel_tpu_torch.models.multimodal import MultiModalModel
from klab_multimodalmodel_tpu_torch.text import ByteTokenizer

MAX_LEN = 12


@pytest.fixture(scope="module")
def lm():
    model = tt5.T5ForConditionalGeneration(
        T5Size(**tp.T5_NAMES["v10"][1]), device="cpu")
    model.init_weights(torch.Generator().manual_seed(0))
    enc = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (3, 5, 32)).astype(np.float32))
    return model.eval(), enc


@pytest.mark.parametrize("chunk", [1, 3, 5, 20])
def test_stream_matches_greedy_any_chunk(lm, chunk):
    model, enc = lm
    with torch.no_grad():
        ref = tgen.greedy_decode(model, enc, None, MAX_LEN).numpy()
        outs = list(tgen.stream_decode(model, enc, None, MAX_LEN,
                                       chunk_size=chunk))
    tokens, n_valid, done = outs[-1]
    assert done and np.array_equal(tokens, ref)
    assert all(not d for *_, d in outs[:-1])
    for t, n, _ in outs:
        assert np.array_equal(t[:, :n], ref[:, :n])
    valids = [n for _, n, _ in outs]
    assert valids[0] == 2
    assert all(0 < b - a <= chunk for a, b in zip(valids, valids[1:]))
    if not (ref[:, 1:] == 1).any(axis=1).all():  # some row runs to the end
        assert valids[-1] == MAX_LEN


@pytest.mark.parametrize("chunk", [1, 4])
def test_stream_matches_sampling_same_generator(lm, chunk):
    model, enc = lm
    kw = dict(temperature=1.3, top_k=5, top_p=0.9)
    with torch.no_grad():
        ref = tgen.sample_decode(model, enc, None, MAX_LEN,
                                 torch.Generator().manual_seed(7), **kw)
        outs = list(tgen.stream_decode(
            model, enc, None, MAX_LEN, chunk_size=chunk, do_sample=True,
            generator=torch.Generator().manual_seed(7), **kw))
    assert np.array_equal(outs[-1][0], ref.numpy())


def test_stream_rejects_chunk_zero(lm):
    model, enc = lm
    with pytest.raises(ValueError, match="chunk_size"):
        next(tgen.stream_decode(model, enc, None, MAX_LEN, chunk_size=0))


@pytest.fixture(scope="module")
def captioner():
    _, cfg = tp.configs("v10")
    model = MultiModalModel(cfg, device="cpu")
    model.init_weights(torch.Generator().manual_seed(0))
    return Captioner(cfg, model, ByteTokenizer(), device="cpu")


@pytest.mark.parametrize("sample", [False, True])
def test_caption_stream_equals_caption(captioner, sample):
    images = np.random.default_rng(2).integers(
        0, 256, (2, 32, 32, 3)).astype(np.uint8)
    kw = dict(do_sample=True, top_k=8) if sample else {}
    want = captioner.caption(images, max_length=10,
                             generator=torch.Generator().manual_seed(4), **kw)
    outs = list(captioner.caption_stream(
        images, max_length=10, chunk_size=3,
        generator=torch.Generator().manual_seed(4), **kw))
    texts, done = outs[-1]
    assert done and texts == want
    assert all(not d for _, d in outs[:-1]) and len(outs) >= 2
    for partial, _ in outs:
        assert all(w.startswith(p) for p, w in zip(partial, want))


def test_captioner_computes_in_fp32_on_a_bf16_model(captioner):
    """A model built for bf16 compute (a trainer's) captions in fp32 with
    its own parameters, exactly as an fp32 model with the same weights, and
    gets its bf16 compute back after the call."""
    cfg = captioner.config
    bf16 = MultiModalModel(cfg, dtype=torch.bfloat16, device="cpu")
    bf16.load_state_dict(captioner.model.state_dict(), strict=True)
    before = {n: m.dtype for n, m in bf16.named_modules()
              if isinstance(getattr(m, "dtype", None), torch.dtype)}
    assert set(before.values()) == {torch.bfloat16}
    images = np.random.default_rng(3).integers(
        0, 256, (2, 32, 32, 3)).astype(np.uint8)
    cap = Captioner(cfg, bf16, ByteTokenizer(), device="cpu")
    enc, _ = cap._encode_prefill(images, None)
    want, _ = captioner._encode_prefill(images, None)
    assert enc.dtype == torch.float32
    torch.testing.assert_close(enc, want, rtol=0, atol=0)
    torch.testing.assert_close(cap.caption_launch(images, num_beams=2),
                               captioner.caption_launch(images, num_beams=2),
                               rtol=0, atol=0)
    after = {n: m.dtype for n, m in bf16.named_modules()
             if isinstance(getattr(m, "dtype", None), torch.dtype)}
    assert after == before
    assert all(getattr(m, "compute_dtype", torch.bfloat16) == torch.bfloat16
               for m in bf16.modules())
