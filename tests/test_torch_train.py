"""The port's ``Trainer`` against the JAX package's ``Trainer`` on a
one-device CPU mesh, step 1 (the later steps: test_torch_train_steps.py): the same converted initial weights, the same batches,
dropout 0 (the tiny sizes of ``tests/_torch_port.py``), compute fp32, with
the kernel flags on (JAX in Pallas interpret mode, the port on its plain
kernel versions: forward, plain backward with the bias gradient) and off.

Tolerances (fp32, summation order through a 2+2+2-layer cascade): the
step-1 gradient of every trainable tensor within 1e-4 of its norm, and the
losses of four Adam steps within 1e-4 relative. Parameters after several
steps are not compared elementwise: a near-zero gradient whose sign flips
under rounding moves that element by +-lr.
"""

import numpy as np
import pytest
import torch

import jax

import _torch_port as tp
from klab_multimodalmodel_tpu.ops import set_interpret
from klab_multimodalmodel_tpu.train.trainer import Trainer as JaxTrainer
from klab_multimodalmodel_tpu.utils import make_mesh
from klab_multimodalmodel_tpu_torch.checkpoint.from_jax import (
    convert_jax_params)
from klab_multimodalmodel_tpu_torch.train.trainer import Trainer

B, SRC, TGT = 4, 32, 8
TOL = 1e-4


@pytest.fixture(autouse=True)
def interpret_mode():
    set_interpret(True)
    yield
    set_interpret(False)


def make_batch(cfg, seed: int) -> dict:
    """Seeded uint8 images, prompt ids with padded rows, captions with one
    padded target row (left out of the loss by its mask)."""
    g = np.random.default_rng(seed)
    S = cfg.swin.image_size
    batch = dict(
        images=g.integers(0, 256, (B, S, S, 3), dtype=np.uint8),
        source_ids=g.integers(2, 512, (B, SRC)).astype(np.int32),
        source_mask=np.ones((B, SRC), np.int32),
        target_ids=g.integers(2, 512, (B, TGT)).astype(np.int32),
        target_mask=np.ones((B, TGT), np.int32))
    batch["source_mask"][1, 20:] = 0
    batch["source_mask"][3, 9:] = 0
    batch["target_mask"][2, 5:] = 0
    return batch


@pytest.fixture(scope="module")
def params():
    jc, _ = tp.configs(max_target_length=TGT)
    return tp.jax_multimodal_params(jc, seed=0)


def _pair(params, kernels, **overrides):
    """(JAX Trainer with its state, port Trainer) on the same weights."""
    jc, tc = tp.configs(kernels=kernels, compute_dtype="float32",
                        max_target_length=TGT, **overrides)
    mesh = make_mesh((1, 1, 1), devices=jax.devices()[:1])
    jt = JaxTrainer(jc, mesh, num_epochs=1)
    state = tp.jax_train_state(jt, params)
    tt = Trainer(tc, device="cpu")
    tt.init_state(state_dict=convert_jax_params(params, tc))
    return jt, state, tt


@pytest.mark.parametrize("kernels", [True, False], ids=["kernels", "plain"])
def test_step1_gradients_match_jax(params, kernels):
    jt, state, tt = _pair(params, kernels)
    batch = make_batch(jt.config, 0)
    loss_fn = jax.jit(jax.value_and_grad(jt._loss_fn), static_argnums=3)
    jloss, jgrads = loss_fn(state.params, batch, jax.random.PRNGKey(1),
                            False)
    loss = tt.train_step(batch, torch.Generator().manual_seed(0))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=TOL)
    want = convert_jax_params(jax.tree.map(np.asarray, jgrads), tt.config)
    checked = 0
    for name, p in tt.model.named_parameters():
        top = name.split(".")[0]
        if top in ("image_model", "language_model"):
            # Frozen towers: no gradient and no update (the JAX package's
            # stop_gradient gives zeros there).
            assert p.grad is None and not p.requires_grad, name
            assert float(np.abs(want[name].numpy()).max()) == 0.0, name
            continue
        w = want[name]
        rel = float((p.grad - w).norm() / w.norm())
        assert rel <= TOL, (name, rel)
        checked += 1
    # Both relative-position tables take their gradient (through the
    # kernel's bias gradient when the kernels are on).
    for stack in ("encoder", "decoder"):
        name = (f"transformer.{stack}.block.0.layer.0.SelfAttention."
                "relative_attention_bias.weight")
        assert float(tt.model.get_parameter(name).grad.abs().max()) > 0
    assert checked > 20
