"""The port's greedy-decode helpers and host-side preprocessing against the
JAX package's: HF logits processors, greedy captions with processors on,
the byte tokenizer, prompt bucketing and image normalization."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import _torch_port as tp
from klab_multimodalmodel_tpu.data.image_ops import (
    normalize_images as j_normalize)
from klab_multimodalmodel_tpu.infer.captioner import Captioner as JCaptioner
from klab_multimodalmodel_tpu.infer.generate import (
    process_logits as j_process_logits)
from klab_multimodalmodel_tpu.ops import set_interpret
from klab_multimodalmodel_tpu.text import ByteTokenizer as JByteTokenizer
from klab_multimodalmodel_tpu.utils.bucketing import (
    pow2_bucket_width as j_bucket)
from klab_multimodalmodel_tpu_torch.checkpoint.from_jax import (
    convert_jax_params)
from klab_multimodalmodel_tpu_torch.data.datasets import COCO_PROMPT
from klab_multimodalmodel_tpu_torch.data.image_ops import normalize_images
from klab_multimodalmodel_tpu_torch.infer.captioner import Captioner
from klab_multimodalmodel_tpu_torch.infer.generate import process_logits
from klab_multimodalmodel_tpu_torch.text import ByteTokenizer
from klab_multimodalmodel_tpu_torch.utils.bucketing import pow2_bucket_width


@pytest.mark.parametrize("min_length,penalty,ngram", [
    (0, 1.0, 0), (6, 1.0, 0), (0, 1.3, 0), (0, 1.0, 2), (0, 1.0, 3),
    (5, 0.7, 2)])
@pytest.mark.parametrize("step", [0, 3, 6])
def test_process_logits_matches_jax(rng, step, min_length, penalty, ngram):
    B, L, V = 3, 8, 40
    logits = rng.standard_normal((B, V)).astype(np.float32)
    tokens = rng.integers(0, 6, (B, L)).astype(np.int32)  # repeats likely
    tokens[:, step + 1:] = 0
    want = j_process_logits(jnp.asarray(logits), jnp.asarray(tokens),
                            jnp.asarray(step), 1, min_length, penalty, ngram)
    got = process_logits(torch.from_numpy(logits), torch.from_numpy(tokens),
                         step, 1, min_length, penalty, ngram)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_greedy_with_processors_matches_jax(rng):
    set_interpret(True)
    try:
        jcfg, tcfg = tp.configs("v11")
        params = tp.jax_multimodal_params(jcfg, seed=1)
        images = rng.integers(0, 256, (2, 32, 32, 3)).astype(np.uint8)
        kw = dict(min_length=4, repetition_penalty=1.5,
                  no_repeat_ngram_size=2)
        want = np.asarray(JCaptioner(jcfg, params, JByteTokenizer())
                          .caption_launch(images, **kw))
        got = Captioner(tcfg, convert_jax_params(params, tcfg),
                        ByteTokenizer(), device="cpu").caption_launch(
                            images, **kw)
        np.testing.assert_array_equal(got.numpy(), want)
    finally:
        set_interpret(False)


def test_tokenizer_bucketing_and_images_match_jax(rng):
    prompts = [COCO_PROMPT, "a <extra_id_0> dog", "", "é" * 40]
    want = JByteTokenizer()(prompts, max_length=32)
    got = ByteTokenizer()(prompts, max_length=32)
    np.testing.assert_array_equal(got.input_ids, want.input_ids)
    np.testing.assert_array_equal(got.attention_mask, want.attention_mask)
    assert int(got.attention_mask[0].sum()) == 30  # the COCO prompt's ids
    assert pow2_bucket_width(got.attention_mask, 16) == j_bucket(
        want.attention_mask, 16) == 32
    ids = np.asarray(got.input_ids)
    assert (ByteTokenizer().batch_decode(ids)
            == JByteTokenizer().batch_decode(ids))
    images = rng.integers(0, 256, (2, 8, 8, 3)).astype(np.uint8)
    np.testing.assert_allclose(
        normalize_images(torch.from_numpy(images)).numpy(),
        np.asarray(j_normalize(jnp.asarray(images))), rtol=1e-6, atol=1e-6)
