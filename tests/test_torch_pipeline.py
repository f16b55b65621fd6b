"""The port's GPipe schedule (``T5Stack._pipelined``) against the JAX
package's (``_PipelineTicks``) on one device, fp32, 4 + 4 layers in 2
stages:

- the pipelined model's loss within 1e-5 and every gradient within 1e-4 of
  its largest value, against JAX's pipelined model (M = 2 and 4) and
  against the port's own unpipelined model on the same weights;
- ``convert_jax_params`` of a pipelined JAX tree equals that of its
  unpipelined tree, bitwise;
- the config refuses what the JAX config refuses, with its message;
- a pipelined ``Trainer`` step equals the unpipelined one; a pipelined
  ``Captioner`` equals an unpipelined one.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import _torch_port as tp
import klab_multimodalmodel_tpu.config as jcfg
import klab_multimodalmodel_tpu.models.t5 as jt5
import klab_multimodalmodel_tpu_torch.config as tcfg
from klab_multimodalmodel_tpu_torch.checkpoint.from_jax import (
    convert_jax_params, convert_t5_lm)
from klab_multimodalmodel_tpu_torch.models import t5 as tt5

KW = dict(tp.TINY_T5, num_layers=4, num_decoder_layers=4)
B, SRC, TGT = 8, 12, 8
PIPE_T5 = "t5-torchport-tiny-4layer"
jcfg.register_t5_size(PIPE_T5, jcfg.T5Size(**KW))
tcfg.register_t5_size(PIPE_T5, tcfg.T5Size(**KW))


@pytest.fixture(scope="module")
def lm():
    """Seeded JAX params of the unpipelined model and seeded inputs."""
    jmodel = jt5.T5ForConditionalGeneration(jcfg.T5Size(**KW))
    rng = np.random.default_rng(0)
    src = rng.integers(2, 512, (B, SRC)).astype(np.int32)
    smask = (rng.random((B, SRC)) > 0.2).astype(np.int32)
    smask[:, 0] = 1
    labels = rng.integers(2, 512, (B, TGT)).astype(np.int32)
    params = jax.tree.map(np.array, jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), src[:1], attention_mask=smask[:1],
        labels=labels[:1])["params"])
    return params, src, smask, labels


def port_lm(params, **kw):
    model = tt5.T5ForConditionalGeneration(tcfg.T5Size(**KW), device="cpu",
                                           **kw)
    model.load_state_dict({k: torch.tensor(v) for k, v in convert_t5_lm(
        params, tcfg.T5Size(**KW)).items()}, strict=True)
    return model


def port_loss_and_grads(model, src, smask, labels):
    model.zero_grad()
    out = model(input_ids=torch.from_numpy(src),
                attention_mask=torch.from_numpy(smask),
                labels=torch.from_numpy(labels))
    out.loss.backward()
    return out.loss.item(), {n: p.grad.clone()
                             for n, p in model.named_parameters()}


def assert_grads_close(got, want, tol):
    assert got.keys() == want.keys()
    for name, w in want.items():
        w = torch.as_tensor(np.array(w))
        err = float((got[name] - w).abs().max())
        assert err <= tol * float(w.abs().max()), (name, err)


@pytest.mark.parametrize("microbatches", [2, 4])
def test_pipelined_model_matches_jax_and_unpipelined(lm, microbatches):
    params, src, smask, labels = lm
    jmodel = jt5.T5ForConditionalGeneration(
        jcfg.T5Size(**KW), pipeline_stages=2,
        pipeline_microbatches=microbatches)
    pparams = jax.tree.map(np.asarray, jt5.pipeline_t5_params(params, 2))
    assert "pipeline" in pparams["encoder"]

    def loss_fn(p):
        return jmodel.apply({"params": p}, input_ids=src,
                            attention_mask=smask, labels=labels).loss

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(
        jax.tree.map(jnp.asarray, pparams))
    want = convert_t5_lm(jax.tree.map(np.asarray, jgrads),
                         tcfg.T5Size(**KW))
    piped = port_lm(pparams, pipeline_stages=2,
                    pipeline_microbatches=microbatches)
    loss, grads = port_loss_and_grads(piped, src, smask, labels)
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-5)
    assert_grads_close(grads, want, 1e-4)
    plain_loss, plain_grads = port_loss_and_grads(port_lm(params), src,
                                                  smask, labels)
    np.testing.assert_allclose(loss, plain_loss, rtol=1e-5)
    assert_grads_close(grads, plain_grads, 1e-4)


def test_convert_pipelined_tree_is_bitwise_the_unpipelined(lm):
    params = lm[0]
    size = tcfg.T5Size(**KW)
    want = convert_t5_lm(params, size)
    for stages in (2, 4):
        got = convert_t5_lm(jax.tree.map(
            np.asarray, jt5.pipeline_t5_params(params, stages)), size)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # A whole cascade's tree: the transformer pipelined, the towers not.
    jc, tc = tp.configs(kernels=False, transformer_model_name=PIPE_T5)
    flat = tp.jax_multimodal_params(jc)
    full = dict(flat, transformer=jax.tree.map(
        np.asarray, jt5.pipeline_t5_params(flat["transformer"], 2)))
    got, want = convert_jax_params(full, tc), convert_jax_params(flat, tc)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


REFUSED = [
    dict(pipeline_stages=2, use_pallas_t5_attention=True),
    dict(pipeline_stages=2, mesh_shape=(1, 1, 1, 1, 3)),
    dict(pipeline_stages=2, mesh_shape=(1, 1, 1, 2, 2)),
    dict(pipeline_stages=2, mesh_shape=(1, 1, 1, 1, 1, 2)),
    dict(pipeline_stages=2, moe_experts=4),
    dict(moe_experts=4, moe_top_k=3),
    dict(moe_experts=4, moe_capacity_factor=0.0),
    dict(moe_experts=4, bucket_lengths=True),
    dict(moe_experts=3, mesh_shape=(1, 1, 1, 1, 1, 2)),
    dict(moe_experts=4, dcn_mesh_shape=(1, 1, 1, 1, 2, 1)),
]


@pytest.mark.parametrize("overrides", REFUSED,
                         ids=lambda o: ",".join(f"{k}={v}"
                                                for k, v in o.items()))
def test_config_refuses_what_jax_refuses(overrides):
    with pytest.raises(ValueError) as want:
        jcfg.Config(**overrides)
    with pytest.raises(ValueError) as got:
        tcfg.Config(**overrides)
    assert str(got.value) == str(want.value)


def test_config_takes_what_jax_takes():
    """The flags build as JAX's, a pipe or expert axis above 1 among them
    (the port splits the stages or the experts over those ranks); beside
    fsdp both axes build as JAX's too."""
    for kw in (dict(pipeline_stages=2, pipeline_microbatches=4),
               dict(moe_experts=4, moe_top_k=2, moe_capacity_factor=2.0,
                    moe_aux_loss_weight=0.1)):
        j, t = jcfg.Config(**kw), tcfg.Config(**kw)
        for name in kw:
            assert getattr(t, name) == getattr(j, name)
    for kw in (dict(pipeline_stages=2, mesh_shape=(1, 1, 1, 1, 2)),
               dict(moe_experts=4, mesh_shape=(1, 1, 1, 1, 1, 2))):
        j, t = jcfg.Config(**kw), tcfg.Config(**kw)
        assert tuple(t.mesh_shape) == tuple(j.mesh_shape)
        fsdp = dict(kw, mesh_shape=(1, 2, *kw["mesh_shape"][2:]))
        j = jcfg.Config(**fsdp)
        assert tuple(tcfg.Config(**fsdp).mesh_shape) == tuple(j.mesh_shape)


def test_stack_refuses_what_it_cannot_schedule(lm):
    params, src, smask, labels = lm
    model = port_lm(params, pipeline_stages=2, pipeline_microbatches=3)
    with pytest.raises(ValueError, match="not divisible by "
                                         "pipeline_microbatches=3"):
        model(input_ids=torch.from_numpy(src), labels=torch.from_numpy(
            labels))
    enc = torch.zeros(2, SRC, KW["d_model"])
    with pytest.raises(ValueError, match="incremental decode"):
        model.decode_step(torch.zeros(2, 1, dtype=torch.int32), 0, enc, 4)
    with pytest.raises(ValueError, match="not divisible by pipeline_stages"):
        port_lm(params, pipeline_stages=3)(
            input_ids=torch.from_numpy(src), labels=torch.from_numpy(labels))


def _cascade(stages, **kw):
    return tp.configs(kernels=False, compute_dtype="float32",
                      transformer_model_name=PIPE_T5, max_target_length=TGT,
                      pipeline_stages=stages,
                      pipeline_microbatches=4 if stages > 1 else 0, **kw)[1]


def test_trainer_step_pipelined_equals_unpipelined():
    from klab_multimodalmodel_tpu_torch.train.trainer import Trainer
    from test_torch_moe_model import _cascade_batch

    cfg1, sd = tp.port_cascade_state(
        kernels=False, transformer_model_name=PIPE_T5)
    batch = _cascade_batch(cfg1, 0, rows=8)
    runs = []
    for stages in (1, 2):
        t = Trainer(_cascade(stages), device="cpu")
        t.init_state(state_dict=sd)
        loss = t.train_step(batch, torch.Generator().manual_seed(0))
        runs.append((loss.item(), {n: p.grad.clone() for n, p in
                                   t.model.named_parameters()
                                   if p.grad is not None}))
    (l1, g1), (l2, g2) = runs
    np.testing.assert_allclose(l2, l1, rtol=1e-5)
    assert_grads_close(g2, g1, 1e-4)
    with pytest.raises(ValueError, match="pipeline_microbatches=4"):
        t.train_step({k: v[:6] for k, v in batch.items()})


def test_pipelined_captioner_equals_unpipelined():
    from klab_multimodalmodel_tpu_torch.infer.captioner import Captioner
    from klab_multimodalmodel_tpu_torch.models.multimodal import (
        MultiModalModel)
    from klab_multimodalmodel_tpu_torch.text import ByteTokenizer

    _, sd = tp.port_cascade_state(kernels=False,
                                  transformer_model_name=PIPE_T5)
    images = np.random.default_rng(1).integers(0, 256, (3, 32, 32, 3),
                                               dtype=np.uint8)
    want = Captioner(_cascade(1), sd, ByteTokenizer(),
                     device="cpu").caption_launch(images)
    cap = Captioner(_cascade(2), sd, ByteTokenizer(), device="cpu")
    assert cap.config.pipeline_stages == 1
    assert torch.equal(cap.caption_launch(images), want)
    # A pipelined model passed in (a trainer's) decodes with one stage and
    # keeps its schedule afterwards.
    model = MultiModalModel(_cascade(2), device="cpu")
    model.load_state_dict(sd, strict=True)
    cap = Captioner(_cascade(2), model, ByteTokenizer(), device="cpu")
    assert torch.equal(cap.caption_launch(images), want)
    assert model.transformer.encoder.pipeline_stages == 2
    assert dataclasses.replace(cap.config).pipeline_microbatches == 0
