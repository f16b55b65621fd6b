"""The port's captioning cascade against the JAX package's, with both kernel
flags on (JAX in Pallas interpret mode, the port on its plain versions):
the multimodal encoder at 1e-4, greedy caption tokens exactly, and the
weight conversion under ``strict=True``."""

import numpy as np
import pytest
import torch

import jax

import _torch_port as tp
from klab_multimodalmodel_tpu.infer.captioner import Captioner as JCaptioner
from klab_multimodalmodel_tpu.models.multimodal import (
    MultiModalModel as JModel)
from klab_multimodalmodel_tpu.ops import set_interpret
from klab_multimodalmodel_tpu.text import ByteTokenizer as JByteTokenizer
from klab_multimodalmodel_tpu_torch.checkpoint.from_jax import (
    convert_jax_params)
from klab_multimodalmodel_tpu_torch.infer.captioner import Captioner
from klab_multimodalmodel_tpu_torch.infer.generate import generate
from klab_multimodalmodel_tpu_torch.models.multimodal import MultiModalModel
from klab_multimodalmodel_tpu_torch.text import ByteTokenizer

ENC_TOL = 1e-4  # three fp32 towers in cascade, summation order


@pytest.fixture(autouse=True)
def interpret_mode():
    set_interpret(True)
    yield
    set_interpret(False)


@pytest.fixture(scope="module", params=["v10", "v11"])
def cascade(request):
    jcfg, tcfg = tp.configs(request.param)
    params = tp.jax_multimodal_params(jcfg, seed=0)
    return jcfg, tcfg, params


def test_convert_jax_params_loads_strict(cascade):
    _, tcfg, params = cascade
    sd = convert_jax_params(params, tcfg)
    model = MultiModalModel(tcfg, device="cpu")
    model.load_state_dict(sd, strict=True)
    assert all(v.dtype == torch.float32 for v in sd.values())
    vp = model.vision_projection.weight
    np.testing.assert_array_equal(
        vp.detach().numpy(), params["vision_projection"]["kernel"].T)


def test_encode_for_generation_matches_jax(cascade, rng):
    jcfg, tcfg, params = cascade
    images = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    ids = rng.integers(3, 300, (2, 16)).astype(np.int32)
    mask = np.ones((2, 16), np.int32)
    mask[1, 9:] = 0
    jmodel = JModel(jcfg)
    jenc, jmask = jax.jit(lambda p, *a: jmodel.apply(
        {"params": p}, *a, method=jmodel.encode_for_generation))(
            params, images, ids, mask)
    model = MultiModalModel(tcfg, device="cpu")
    model.load_state_dict(convert_jax_params(params, tcfg), strict=True)
    with torch.no_grad():
        enc, cmask = model.encode_for_generation(
            torch.from_numpy(images), torch.from_numpy(ids),
            torch.from_numpy(mask))
    np.testing.assert_array_equal(cmask.numpy(), np.asarray(jmask))
    np.testing.assert_allclose(enc.numpy(), np.asarray(jenc), rtol=ENC_TOL,
                               atol=ENC_TOL)


def _step_margins(model, enc, enc_mask, tokens):
    """Top-1 minus top-2 logit of every decode step of the port's greedy
    run (teacher-forced on its own tokens), for rows still running."""
    margins = []
    cache = None
    finished = torch.zeros(tokens.shape[0], dtype=torch.bool)
    for step in range(tokens.shape[1] - 1):
        logits, cache = model.transformer.decode_step(
            tokens[:, step:step + 1], step, enc, tokens.shape[1], enc_mask,
            cache=cache)
        top2 = logits[:, -1].topk(2, dim=-1).values
        margins.append(torch.where(finished, torch.inf,
                                   top2[:, 0] - top2[:, 1]))
        finished = finished | (tokens[:, step + 1] == 1)
    return torch.stack(margins, 1)


def test_caption_tokens_match_jax_exactly(cascade, rng):
    jcfg, tcfg, params = cascade
    images = rng.integers(0, 256, (3, 32, 32, 3)).astype(np.uint8)
    jcap = JCaptioner(jcfg, params, JByteTokenizer())
    want = np.asarray(jcap.caption_launch(images))
    cap = Captioner(tcfg, convert_jax_params(params, tcfg), ByteTokenizer(),
                    device="cpu")
    got = cap.caption_launch(images)
    assert got.shape == (3, tcfg.generate_max_length)
    assert (got[:, 0] == 0).all()
    # Every greedy choice is far from a tie (fp32 drift between the two
    # frameworks is ~1e-5), so exact equality tests the decode logic and
    # a mismatch cannot be a near-tie flip.
    with torch.no_grad():
        enc, enc_mask = cap._encode_prefill(images, None)
        margins = _step_margins(cap.model, enc, enc_mask, got)
    np.testing.assert_array_equal(
        got.numpy(), want,
        err_msg=f"smallest step margin {margins.min().item():.3g}")
    assert margins.min().item() > 1e-3
    assert cap.caption(images) == jcap.caption(images)


def test_generate_refuses_beams_and_sampling(cascade):
    """Beams and sampling each run; what is still refused is the two
    together (HF's ValueError) and a negative draft length. Speculative
    decoding (ROADMAP A10) runs, with greedy's tokens."""
    _, tcfg, params = cascade
    cap = Captioner(tcfg, convert_jax_params(params, tcfg), ByteTokenizer(),
                    device="cpu")
    images = np.zeros((1, 32, 32, 3), np.uint8)
    assert len(cap.caption(images, num_beams=2)) == 1
    assert len(cap.caption(images, do_sample=True)) == 1
    with pytest.raises(ValueError, match="beam-search sampling"):
        cap.caption(images, num_beams=2, do_sample=True)
    enc = torch.randn(1, 4, 32, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        torch.testing.assert_close(
            generate(cap.model.transformer, enc, None, speculative_draft=4),
            generate(cap.model.transformer, enc, None), rtol=0, atol=0)
    with pytest.raises(ValueError, match="speculative_draft"):
        generate(cap.model.transformer, enc, None, speculative_draft=-1)


def test_seeded_init_is_reproducible(cascade):
    _, tcfg, _ = cascade
    sds = []
    for _ in range(2):
        model = MultiModalModel(tcfg, device="cpu")
        model.init_weights(torch.Generator().manual_seed(0))
        sds.append(model.state_dict())
    for k, v in sds[0].items():
        assert torch.isfinite(v).all(), k
        torch.testing.assert_close(v, sds[1][k], rtol=0, atol=0)
    eye = torch.eye(sds[0]["vision_projection.weight"].shape[0])
    torch.testing.assert_close(sds[0]["vision_projection.weight"], eye)
