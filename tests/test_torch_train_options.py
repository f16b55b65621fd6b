"""The training step's options: the bf16 compute policy against the JAX
package, gradient accumulation, the cached-feature loss, the learning-rate
schedules against the JAX package's, the frozen towers, dropout, and the
configuration values the port takes and refuses."""

import dataclasses

import numpy as np
import pytest
import torch

import jax

import _torch_port as tp
import klab_multimodalmodel_tpu.config as jcfg
import klab_multimodalmodel_tpu_torch.config as tcfg
from klab_multimodalmodel_tpu.ops import set_interpret
from klab_multimodalmodel_tpu.train.optim import (
    make_lr_schedule as jax_schedule)
from klab_multimodalmodel_tpu.train.trainer import Trainer as JaxTrainer
from klab_multimodalmodel_tpu.utils import make_mesh
from klab_multimodalmodel_tpu_torch.checkpoint.from_jax import (
    convert_jax_params)
from klab_multimodalmodel_tpu_torch.data.image_ops import normalize_images
from klab_multimodalmodel_tpu_torch.ops import t5_attention, t5_attention_bwd
from klab_multimodalmodel_tpu_torch.train.optim import (make_lr_schedule,
                                                        trainable_names)
from klab_multimodalmodel_tpu_torch.train.trainer import Trainer
from test_torch_train import TGT, make_batch

DROP_T5 = "t5-torchport-tiny-dropout"
for _cfg in (jcfg, tcfg):
    _cfg.register_t5_size(DROP_T5, _cfg.T5Size(**dict(tp.TINY_T5,
                                                       dropout_rate=0.1)))


@pytest.fixture(autouse=True)
def interpret_mode():
    set_interpret(True)
    yield
    set_interpret(False)


@pytest.fixture(scope="module")
def params():
    jc, _ = tp.configs(max_target_length=TGT)
    return tp.jax_multimodal_params(jc, seed=0)


def _port(params, **overrides) -> Trainer:
    _, tc = tp.configs(max_target_length=TGT, **overrides)
    tt = Trainer(tc, device="cpu")
    tt.init_state(state_dict=convert_jax_params(params, tc))
    return tt


def test_bf16_step1_loss_matches_jax(params):
    """Compute bf16 (the default policy), kernel flags on: the step-1 loss
    within 2e-2 relative (bf16 rounds at other places in the two
    frameworks: matmul outputs, bias adds, the tied head's scale)."""
    jc, tc = tp.configs(max_target_length=TGT)
    assert jc.compute_dtype == tc.compute_dtype == "bfloat16"
    jt = JaxTrainer(jc, make_mesh((1, 1, 1), devices=jax.devices()[:1]))
    state = tp.jax_train_state(jt, params)
    batch = make_batch(jc, 0)
    jloss = jax.jit(jt._loss_fn, static_argnums=3)(
        state.params, batch, jax.random.PRNGKey(1), False)
    tt = _port(params)
    assert tt.model.dtype == torch.bfloat16
    loss = tt.train_step(batch, torch.Generator().manual_seed(0))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=2e-2)
    # Parameters and their gradients stay fp32.
    p = tt.model.transformer.encoder.block[0].layer[0]["SelfAttention"].q
    assert p.weight.dtype == torch.float32
    assert p.weight.grad.dtype == torch.float32


def _grads(tt):
    return {n: p.grad.clone() for n, p in tt.model.named_parameters()
            if p.grad is not None}


def test_accumulation_matches_one_microbatch(params):
    """accumulation_steps=2 at the same global batch: the mean of the two
    microbatch losses and the mean of their gradients equal one pass over
    the whole batch (both halves carry the same number of target tokens, so
    the means agree). fp32, tolerance 1e-5 (summation order)."""
    one = _port(params, compute_dtype="float32")
    two = _port(params, compute_dtype="float32", accumulation_steps=2)
    batch = make_batch(one.config, 1)
    batch["target_mask"][:] = 1
    l1 = one.train_step(batch)
    l2 = two.train_step(batch)
    np.testing.assert_allclose(float(l2), float(l1), rtol=1e-5)
    g1, g2 = _grads(one), _grads(two)
    assert g1.keys() == g2.keys()
    for name in g1:
        rel = float((g2[name] - g1[name]).norm() / g1[name].norm())
        assert rel <= 1e-5, (name, rel)
    with pytest.raises(ValueError, match="multiple"):
        _port(params, accumulation_steps=3).train_step(batch)


def test_loss_from_image_features_matches_forward(params):
    """The cached-feature loss equals the loss from the images, with and
    without cached text features, and the with-features step hands back
    the towers' outputs."""
    tt = _port(params, compute_dtype="float32")
    batch = tt.to_device(make_batch(tt.config, 2))
    model = tt.model
    with torch.no_grad():
        images = normalize_images(batch["images"])
        want = model(images, batch["source_ids"], batch["target_ids"],
                     batch["source_mask"], batch["target_mask"]).loss
        img = model.image_features(images)
        lang = model.language_features(batch["source_ids"],
                                       batch["source_mask"])
        for feats in (None, lang):
            got = model.loss_from_image_features(
                img, batch["source_ids"], batch["target_ids"],
                batch["source_mask"], batch["target_mask"],
                language_features=feats).loss
            assert torch.equal(got, want)
    loss, (fimg, flang) = tt.eval_step_with_features(batch)
    assert torch.equal(loss, want)
    assert torch.equal(fimg, img) and torch.equal(flang, lang)
    step_loss, (simg, _) = tt.train_step_with_features(batch)
    assert torch.equal(step_loss, want) and torch.equal(simg, img)
    cached = {k: v for k, v in batch.items() if k != "images"}
    cached["image_features"] = img
    after = tt.eval_step(cached)
    assert float(after) != float(want)  # the step moved the weights


@pytest.mark.parametrize("name", ["", "cosine", "linear", "exponential",
                                  "step"])
def test_schedules_match_optax(name):
    """Each schedule at 0-based steps 0..24 against the JAX package's
    (optax, fp32), and the optimizer's own learning rate at step n."""
    num_epochs = 7
    want_fn = jax_schedule(jcfg.Config(lr=2e-3, lr_scheduler=name),
                           num_epochs)
    got_fn = make_lr_schedule(tcfg.Config(lr=2e-3, lr_scheduler=name),
                              num_epochs)
    steps = list(range(25))
    want = [float(want_fn(n)) for n in steps]
    got = [got_fn(n) for n in steps]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)
    # The LambdaLR the trainer steps once per update reaches the same rate.
    w = torch.nn.Parameter(torch.zeros(2))
    model = torch.nn.Module()
    model.transformer = torch.nn.ParameterDict({"w": w})
    from klab_multimodalmodel_tpu_torch.train.optim import make_optimizer
    opt, sched = make_optimizer(tcfg.Config(lr=2e-3, lr_scheduler=name),
                                model, num_epochs)
    for n in steps[:12]:
        assert opt.param_groups[0]["lr"] == pytest.approx(got[n], rel=1e-12)
        w.grad = torch.ones(2)
        opt.step()
        sched.step()


@pytest.mark.parametrize("overrides,match", [
    (dict(profile_server_port=9012), "no live profiler server"),
])
def test_config_refuses_what_is_not_ported(overrides, match):
    with pytest.raises(NotImplementedError, match=match):
        tcfg.Config(**overrides)


@pytest.mark.parametrize("overrides", [
    dict(remat="selective"), dict(optimizer="sgd"),
    dict(adam_mu_dtype="float16"), dict(frozen_param_dtype="int8"),
])
def test_config_refuses_unknown_values(overrides):
    with pytest.raises(ValueError):
        tcfg.Config(**overrides)


@pytest.mark.parametrize("overrides", [
    dict(image_model_train=True), dict(optimizer="adafactor"),
    dict(adam_mu_dtype="bfloat16"), dict(frozen_param_dtype="bfloat16"),
    dict(remat="full"), dict(remat="dots_saveable"),
])
def test_config_takes_every_training_option(overrides):
    """Every training option of the JAX ``Trainer`` constructs (each is
    trained in test_torch_train_swin.py, test_torch_train_storage.py and
    test_torch_remat.py)."""
    for name, value in overrides.items():
        assert getattr(tcfg.Config(**overrides), name) == value


def test_frozen_towers_stay_frozen(params):
    """The text tower, and the image tower even with image_model_train
    under freeze_image_model_updates, take no gradient and no update;
    the projections and the transformer do."""
    tt = _port(params, image_model_train=True,
               freeze_image_model_updates=True)
    names = trainable_names(tt.model, tt.config)
    assert names and not any(n.startswith(("image_model.", "language_model."))
                             for n in names)
    assert any(n.startswith("vision_projection.") for n in names)
    before = {n: p.detach().clone() for n, p in tt.model.named_parameters()}
    tt.train_step(make_batch(tt.config, 3))
    for n, p in tt.model.named_parameters():
        moved = not torch.equal(p, before[n])
        assert p.requires_grad == (n in names)
        if n.startswith(("image_model.", "language_model.")):
            assert not moved and p.grad is None, n
    assert not torch.equal(
        tt.model.transformer.decoder.relative_attention_bias.weight,
        before["transformer.decoder.block.0.layer.0.SelfAttention."
               "relative_attention_bias.weight"])


@pytest.mark.parametrize("kernels", [True, False], ids=["kernels", "plain"])
def test_dropout_steps_are_reproducible(params, kernels):
    """Transformer dropout at rate 0.1: a step's loss is a function of the
    weights, the batch and the generator's seed. With the kernel flag on,
    every transformer attention runs the kernel path at rate 0.1 (plain
    versions on the CPU) with its backward; the frozen text tower runs
    at rate 0, forward only."""
    def run(seed):
        tt = _port(params, kernels=kernels, compute_dtype="float32",
                   transformer_model_name=DROP_T5)
        f0, b0 = t5_attention.launches_dropout, t5_attention_bwd.launches
        loss = tt.train_step(make_batch(tt.config, 4),
                             torch.Generator().manual_seed(seed))
        return float(loss), (t5_attention.launches_dropout - f0,
                             t5_attention_bwd.launches - b0)

    a, _ = run(0)
    b, _ = run(0)
    c, _ = run(1)
    assert a == b and a != c
    tt = _port(params, compute_dtype="float32",
               transformer_model_name=DROP_T5)
    det = float(tt.eval_step(make_batch(tt.config, 4)))
    assert det not in (a, c)
    # CPU tensors take the plain versions: the counters count kernel
    # launches only.
    assert run(2)[1] == (0, 0)
    with pytest.raises(ValueError, match="generator"):
        _port(params, kernels=kernels, transformer_model_name=DROP_T5
              ).train_step(make_batch(tt.config, 4))


def test_config_keeps_the_jax_names_and_defaults():
    j, t = jcfg.Config(), tcfg.Config()
    for f in dataclasses.fields(t):
        assert getattr(t, f.name) == getattr(j, f.name), f.name
