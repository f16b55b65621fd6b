"""The port's ``Trainer`` against the JAX package's ``Trainer`` over four
Adam steps and in evaluation, on a one-device CPU mesh, the same set-up as
test_torch_train.py (same weights and batches, dropout 0, compute fp32,
kernel flags on and off). Tolerance: the losses within 1e-4 relative (fp32
summation order through the cascade and the Adam update)."""

import numpy as np
import pytest
import torch

import jax

import _torch_port as tp
from klab_multimodalmodel_tpu.ops import set_interpret
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


@pytest.mark.parametrize("kernels", [True, False], ids=["kernels", "plain"])
def test_four_steps_of_losses_match_jax(params, kernels):
    jt, state, tt = _pair(params, kernels)
    jloss, loss = [], []
    rng = jax.random.PRNGKey(3)
    gen = torch.Generator().manual_seed(3)
    for step in range(4):
        batch = make_batch(jt.config, 10 + step)
        state, jl = jt.train_step(state, jt.device_put_batch(batch), rng)
        jloss.append(float(jl))
        loss.append(float(tt.train_step(batch, gen)))
    np.testing.assert_allclose(loss, jloss, rtol=TOL)
    assert tt.step == 4 and int(state.step) == 4


def test_eval_step_matches_jax(params):
    jt, state, tt = _pair(params, True)
    batch = make_batch(jt.config, 20)
    want = jt.eval_step(state.params, jt.device_put_batch(batch))
    got = tt.eval_step(batch)
    np.testing.assert_allclose(float(got), float(want), rtol=TOL)
