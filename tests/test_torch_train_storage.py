"""The training options that change what the step stores, end to end on the
tiny cascade against the JAX package's ``Trainer`` (one-device CPU mesh, the
set-up of test_torch_train.py): Adafactor and Adam with a bf16 first moment
(three steps of losses in fp32 compute, 1e-4 relative: summation order
through the cascade and the update), and the frozen towers stored in bf16
(bf16 compute, the kernel flags on, the step-1 loss within 2e-2 relative, as
test_torch_train_options.py holds bf16 compute), and ``remat='full'`` (the
step-1 loss in fp32, 1e-4 relative, with the kernel flags off on both
sides: the JAX package does not trace ``nn.remat`` around its Pallas T5
path, whose static group count becomes a tracer; test_torch_remat.py holds
the port's remat against no remat with the flags on). Also the image
normalization's ``reference_double_rescale`` (1e-7 absolute: the same fp32
operations) and the conversion of a JAX state whose frozen leaves are
bf16."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import _torch_port as tp
from klab_multimodalmodel_tpu.data.image_ops import (
    normalize_images as jax_normalize)
from klab_multimodalmodel_tpu.ops import set_interpret
from klab_multimodalmodel_tpu.train.trainer import Trainer as JaxTrainer
from klab_multimodalmodel_tpu.utils import make_mesh
from klab_multimodalmodel_tpu_torch.checkpoint.from_jax import (
    convert_jax_params)
from klab_multimodalmodel_tpu_torch.data.image_ops import normalize_images
from klab_multimodalmodel_tpu_torch.models.multimodal import MultiModalModel
from klab_multimodalmodel_tpu_torch.train.optim import Adafactor, AdamBf16Mu
from klab_multimodalmodel_tpu_torch.train.trainer import Trainer
from test_torch_train import TGT, TOL, _pair, make_batch
from test_torch_train_swin import jax_step


@pytest.fixture(autouse=True)
def interpret_mode():
    set_interpret(True)
    yield
    set_interpret(False)


@pytest.fixture(scope="module")
def params():
    jc, _ = tp.configs(max_target_length=TGT)
    return tp.jax_multimodal_params(jc, seed=0)


@pytest.mark.parametrize("overrides,cls", [
    (dict(optimizer="adafactor"), Adafactor),
    (dict(adam_mu_dtype="bfloat16"), AdamBf16Mu),
], ids=["adafactor", "adam_bf16_mu"])
def test_optimizer_steps_match_jax(params, overrides, cls):
    jt, state, tt = _pair(params, False, **overrides)
    assert isinstance(tt.optimizer, cls)
    step_fn = jax.jit(lambda st, b: jax_step(jt, st, b))
    jlosses, losses = [], []
    for step in range(3):
        batch = make_batch(jt.config, 30 + step)
        jl, _, state = step_fn(state, batch)
        jlosses.append(float(jl))
        losses.append(float(tt.train_step(batch)))
    np.testing.assert_allclose(losses, jlosses, rtol=TOL)
    assert losses[2] != losses[0]


def _bf16_frozen_jax_state(jt, params):
    """The JAX Trainer's state with its frozen towers cast to bf16 by its
    own ``_maybe_cast_frozen``."""
    state = jt._maybe_cast_frozen(tp.jax_train_state(jt, params))
    leaf = state.params["language_model"]["shared"]["embedding"]
    assert leaf.dtype == jnp.bfloat16
    return state


def test_bf16_frozen_towers_step1_loss_matches_jax(params):
    jc, tc = tp.configs(max_target_length=TGT, frozen_param_dtype="bfloat16")
    jt = JaxTrainer(jc, make_mesh((1, 1, 1), devices=jax.devices()[:1]))
    state = _bf16_frozen_jax_state(jt, params)
    batch = make_batch(jc, 0)
    jloss = jax.jit(jt._loss_fn, static_argnums=3)(
        state.params, batch, jax.random.PRNGKey(1), False)
    tt = Trainer(tc, device="cpu")
    tt.init_state(state_dict=convert_jax_params(params, tc))
    for name, p in tt.model.named_parameters():
        frozen = name.startswith(("image_model.", "language_model."))
        assert p.dtype == (torch.bfloat16 if frozen else torch.float32), name
        assert p.requires_grad != frozen, name
    # The buffers stay fp32: window masks and coordinate tables.
    assert all(b.dtype != torch.bfloat16 for b in tt.model.buffers())
    loss = tt.train_step(batch, torch.Generator().manual_seed(0))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=2e-2)
    assert tt.model.vision_projection.weight.grad.dtype == torch.float32


def test_bf16_frozen_jax_state_converts_and_loads(params):
    """A JAX state whose frozen leaves are ``ml_dtypes`` bf16 converts (each
    value exact in fp32) and loads with ``strict=True``; the port's trainer
    then stores the same bf16 values."""
    jc, tc = tp.configs(max_target_length=TGT, frozen_param_dtype="bfloat16")
    jt = JaxTrainer(jc, make_mesh((1, 1, 1), devices=jax.devices()[:1]))
    state = _bf16_frozen_jax_state(jt, params)
    host = jax.tree.map(np.asarray, state.params)
    sd = convert_jax_params(host, tc)
    assert all(t.dtype == torch.float32 for t in sd.values())
    model = MultiModalModel(tc, device="cpu")
    model.load_state_dict(sd, strict=True)
    tt = Trainer(tc, device="cpu")
    tt.init_state(state_dict=sd)
    got = tt.model.language_model.shared.weight
    want = host["language_model"]["shared"]["embedding"]
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.float().numpy(), want.astype(np.float32))


def test_reference_double_rescale_matches_jax():
    images = np.random.default_rng(1).integers(0, 256, (2, 8, 8, 3),
                                                dtype=np.uint8)
    for double in (False, True):
        want = np.asarray(jax_normalize(jnp.asarray(images),
                                        reference_double_rescale=double))
        got = normalize_images(torch.from_numpy(images),
                               reference_double_rescale=double).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
    # The second rescale pulls every pixel to about -mean/std.
    assert float(np.ptp(got[..., 0])) < 0.02


def test_remat_full_step1_loss_matches_jax(params):
    jt, state, tt = _pair(params, False, remat="full")
    assert jt.config.remat == tt.config.remat == "full"
    batch = make_batch(jt.config, 0)
    jloss = jax.jit(jt._loss_fn, static_argnums=3)(
        state.params, batch, jax.random.PRNGKey(1), False)
    loss = tt.train_step(batch, torch.Generator().manual_seed(0))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=TOL)
