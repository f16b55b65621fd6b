"""The port's SwinV2 encoder against the JAX package's, on a tiny geometry
with a shifted stage (4 windows per image, masked) and a stage whose window
shrinks to the feature map. Kernel flag on (JAX in Pallas interpret mode,
the port on its plain version) and off. fp32, tolerance 1e-5."""

import numpy as np
import pytest
import torch

import jax

import _torch_port as tp
import klab_multimodalmodel_tpu.config as jcfg
from klab_multimodalmodel_tpu.models.swinv2 import SwinV2Encoder as JSwin
from klab_multimodalmodel_tpu.ops import set_interpret
from klab_multimodalmodel_tpu_torch.checkpoint.from_jax import convert_swinv2
from klab_multimodalmodel_tpu_torch.config import SwinV2Size
from klab_multimodalmodel_tpu_torch.models.swinv2 import SwinV2Encoder

TOL = 1e-5


@pytest.fixture(autouse=True)
def interpret_mode():
    set_interpret(True)
    yield
    set_interpret(False)


@pytest.fixture(scope="module")
def jax_params():
    size = jcfg.SwinV2Size(**tp.TINY_SWIN)
    params = JSwin(size).init(jax.random.PRNGKey(3),
                              np.zeros((1, 32, 32, 3), np.float32))["params"]
    return jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("kernels", [True, False])
def test_swinv2_encoder_matches_jax(rng, jax_params, kernels):
    images = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    want = JSwin(jcfg.SwinV2Size(**tp.TINY_SWIN), use_pallas=kernels).apply(
        {"params": jax_params}, images)

    size = SwinV2Size(**tp.TINY_SWIN)
    model = SwinV2Encoder(size, use_pallas=kernels, device="cpu")
    model.load_state_dict({k: torch.tensor(v) for k, v in
                           convert_swinv2(jax_params, size).items()},
                          strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(images))
    assert got.shape == (2, size.num_patches_out, size.num_features)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
