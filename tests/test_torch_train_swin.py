"""The ``train_with_swin`` recipe (``image_model_train``): the SwinV2 tower
trains with the transformer. The port's ``Trainer`` against the JAX
package's on a one-device CPU mesh, the same set-up as test_torch_train.py
(same converted weights and batches, dropout 0), with the kernel flags on
(JAX in Pallas interpret mode with its Swin custom VJP, the port on the
plain Swin forward and its recompute backward) and off.

Tolerances: in fp32 compute the step-1 loss within 1e-4 relative, every
trainable gradient (the Swin tower's included) within 1e-4 of its norm,
and the losses of three Adam steps within 1e-4 relative (summation order
through the cascade and the update); in bf16 compute the step-1 loss within
2e-2 relative, as test_torch_train_options.py holds it (bf16 rounds at other
places in the two frameworks)."""

import numpy as np
import pytest
import torch

import jax
import optax

import _torch_port as tp
from klab_multimodalmodel_tpu.ops import set_interpret
from klab_multimodalmodel_tpu.train.trainer import Trainer as JaxTrainer
from klab_multimodalmodel_tpu.utils import make_mesh
from klab_multimodalmodel_tpu_torch.checkpoint.from_jax import (
    convert_jax_params)
from klab_multimodalmodel_tpu_torch.ops import swin_attention
from klab_multimodalmodel_tpu_torch.train.optim import trainable_names
from klab_multimodalmodel_tpu_torch.train.trainer import Trainer
from test_torch_train import TGT, TOL, _pair, make_batch


@pytest.fixture(autouse=True)
def interpret_mode():
    set_interpret(True)
    yield
    set_interpret(False)


@pytest.fixture(scope="module")
def params():
    jc, _ = tp.configs(max_target_length=TGT)
    return tp.jax_multimodal_params(jc, seed=0)


def jax_step(jt, state, batch):
    """(loss, gradients, next state) of the JAX ``Trainer``'s update at
    dropout 0, in one jitted function: its ``_loss_fn`` and its optimizer,
    as its ``train_step`` chains them, with the gradients surfaced."""
    loss, grads = jax.value_and_grad(jt._loss_fn)(state.params, batch, None,
                                                  True)
    updates, opt_state = jt.tx.update(grads, state.opt_state, state.params)
    params = optax.apply_updates(state.params, updates)
    return loss, grads, state.replace(step=state.step + 1, params=params,
                                      opt_state=opt_state)


@pytest.mark.parametrize("kernels", [True, False], ids=["kernels", "plain"])
def test_trainable_tower_matches_jax(params, kernels):
    jt, state, tt = _pair(params, kernels, image_model_train=True)
    names = trainable_names(tt.model, tt.config)
    assert any(n.startswith("image_model.") for n in names)
    batch = make_batch(jt.config, 0)
    step_fn = jax.jit(lambda st, b: jax_step(jt, st, b))
    jloss, jgrads, state = step_fn(state, batch)
    before = {n: p.detach().clone() for n, p in tt.model.named_parameters()}
    gen = torch.Generator().manual_seed(3)
    loss = tt.train_step(batch, gen)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=TOL)
    want = convert_jax_params(jax.tree.map(np.asarray, jgrads), tt.config)
    swin = 0
    for name, p in tt.model.named_parameters():
        if name.startswith("language_model."):
            assert p.grad is None and not p.requires_grad, name
            continue
        w = want[name]
        rel = float((p.grad - w).norm() / w.norm())
        assert rel <= TOL, (name, rel)
        swin += name.startswith("image_model.")
    assert swin == sum(n.startswith("image_model.") for n in names)

    # Two more steps: three steps of losses.
    jlosses, losses = [float(jloss)], [float(loss)]
    for step in (1, 2):
        b = make_batch(jt.config, step)
        jl, _, state = step_fn(state, b)
        jlosses.append(float(jl))
        losses.append(float(tt.train_step(b, gen)))
    np.testing.assert_allclose(losses, jlosses, rtol=TOL)
    # The text tower is bitwise unchanged; every Swin tensor moved (each
    # logit scale and the position-bias MLP included).
    for name, p in tt.model.named_parameters():
        if name.startswith("language_model."):
            assert torch.equal(p, before[name]), name
        elif name.startswith("image_model."):
            assert not torch.equal(p, before[name]), name


def test_trainable_tower_bf16_step1_loss_matches_jax(params):
    """bf16 compute, kernel flags on: the step-1 loss within 2e-2, and the
    Swin tower's gradients reach its fp32 parameters through the kernel
    path's recompute backward (launch counts stay 0 on the CPU)."""
    jc, tc = tp.configs(max_target_length=TGT, image_model_train=True)
    jt = JaxTrainer(jc, make_mesh((1, 1, 1), devices=jax.devices()[:1]))
    state = tp.jax_train_state(jt, params)
    batch = make_batch(jc, 0)
    jloss = jax.jit(jt._loss_fn, static_argnums=3)(
        state.params, batch, jax.random.PRNGKey(1), False)
    tt = Trainer(tc, device="cpu")
    tt.init_state(state_dict=convert_jax_params(params, tc))
    launches = swin_attention.launches
    loss = tt.train_step(batch, torch.Generator().manual_seed(0))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=2e-2)
    assert swin_attention.launches == launches
    scale = tt.model.image_model.encoder["layers"][0]["blocks"][1].attention[
        "self"].logit_scale
    assert scale.dtype == torch.float32 and scale.grad.dtype == torch.float32
    assert float(scale.grad.abs().max()) > 0
