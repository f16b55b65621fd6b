"""The port's mixture of experts through its entry points, against the JAX
package on the CPU (fp32, the tiny sizes of ``tests/_torch_port.py``, 4
experts):

- ``T5ForConditionalGeneration`` with MoE, kernel flags on (the JAX side in
  Pallas interpret mode, the port on its plain versions) and off: loss and
  aux within 1e-4 relative, logits within 1e-4, every gradient within 1e-4
  of its largest value;
- ``decode_step`` against ``decode_train`` (ample capacity, as JAX's
  test); greedy and ``num_beams=1`` tokens against JAX's; speculative
  decode against JAX's speculative decode (tokens, passes, accepts);
- ``Trainer.train_step`` on the three-tower cascade against the JAX
  ``Trainer``; phantom rows leave the loss and gradients unchanged; a
  ``train()`` with a padded accumulation tail runs;
- sparse upcycling bitwise against JAX's, through ``init_checkpoint``, and
  a dense/MoE resume refused both ways;
- int8 decode leaves the router and experts unquantized; the captioner
  does not trim source buckets; the HF export refuses an MoE tree.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import _torch_port as tp
import klab_multimodalmodel_tpu.config as jcfg
import klab_multimodalmodel_tpu.models.t5 as jt5
from klab_multimodalmodel_tpu.ops import set_interpret
from klab_multimodalmodel_tpu_torch.checkpoint.from_jax import (
    convert_jax_params, convert_t5_lm)
from klab_multimodalmodel_tpu_torch.config import T5Size
from klab_multimodalmodel_tpu_torch.infer import generate as tgen
from klab_multimodalmodel_tpu_torch.infer import speculative as tspec
from klab_multimodalmodel_tpu_torch.models import t5 as tt5

jgen = importlib.import_module("klab_multimodalmodel_tpu.infer.generate")
jspec = importlib.import_module("klab_multimodalmodel_tpu.infer.speculative")

TOL = 1e-4
MOE = dict(moe_experts=4, moe_top_k=2, moe_capacity_factor=1.25)
KW = tp.T5_NAMES["v10"][1]
B, SRC, TGT = 3, 12, 8


@pytest.fixture(autouse=True)
def interpret_mode():
    set_interpret(True)
    yield
    set_interpret(False)


@pytest.fixture(scope="module")
def lm():
    """JAX MoE T5's seeded params (numpy) and seeded inputs with padding."""
    jmodel = jt5.T5ForConditionalGeneration(jcfg.T5Size(**KW), **MOE)
    ids = np.zeros((1, SRC), np.int32)
    params = jax.tree.map(np.array, jax.jit(jmodel.init)(
        jax.random.PRNGKey(3), ids, decoder_input_ids=ids[:, :TGT])["params"])
    rng = np.random.default_rng(0)
    src = rng.integers(2, 512, (B, SRC)).astype(np.int32)
    smask = np.ones((B, SRC), np.int32)
    smask[1, 7:] = 0
    labels = rng.integers(2, 512, (B, TGT)).astype(np.int32)
    tmask = np.ones((B, TGT), np.int32)
    tmask[2, 5:] = 0
    return params, src, smask, labels, tmask


def port_lm(params, **kw):
    model = tt5.T5ForConditionalGeneration(T5Size(**KW), device="cpu",
                                           **dict(MOE, **kw))
    model.load_state_dict({k: torch.tensor(v) for k, v in convert_t5_lm(
        params, T5Size(**KW)).items()}, strict=True)
    return model


@pytest.mark.parametrize("kernels,top_k", [(True, 2), (False, 2),
                                           (False, 1)])
def test_model_loss_aux_logits_and_gradients_match_jax(lm, kernels, top_k):
    params, src, smask, labels, tmask = lm
    jmodel = jt5.T5ForConditionalGeneration(
        jcfg.T5Size(**KW), use_pallas=kernels, **dict(MOE, moe_top_k=top_k))

    def loss_fn(p):
        out = jmodel.apply({"params": p}, input_ids=src,
                           attention_mask=smask, labels=labels,
                           label_weights=tmask.astype(np.float32),
                           decoder_attention_mask=tmask)
        return out.loss, (out.aux_loss, out.logits)

    (jloss, (jaux, jlogits)), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(jax.tree.map(jnp.asarray, params))
    model = port_lm(params, use_pallas=kernels, moe_top_k=top_k)
    out = model(input_ids=torch.from_numpy(src),
                attention_mask=torch.from_numpy(smask),
                labels=torch.from_numpy(labels),
                label_weights=torch.from_numpy(tmask).float(),
                decoder_attention_mask=torch.from_numpy(tmask))
    out.loss.backward()
    np.testing.assert_allclose(out.loss.item(), float(jloss), rtol=TOL)
    np.testing.assert_allclose(out.aux_loss.item(), float(jaux), rtol=TOL)
    np.testing.assert_allclose(out.logits.detach().numpy(),
                               np.asarray(jlogits), rtol=0, atol=TOL)
    want = convert_t5_lm(jax.tree.map(np.asarray, jgrads), T5Size(**KW))
    for name, p in model.named_parameters():
        w = want[name]
        err = float((p.grad - torch.tensor(w)).abs().max())
        assert err <= TOL * float(np.abs(w).max()), (name, err)
    mlp = "encoder.block.1.layer.1.mlp."
    for leaf in ("router.weight", "experts_wi", "experts_wo"):
        assert float(model.get_parameter(mlp + leaf).grad.abs().max()) > 0


def test_decode_step_matches_decode_train(lm):
    """With ample capacity (factor 8: nothing overflows) routing is per
    token, so the cache path equals teacher forcing at every position (the
    JAX package's test_moe.py:308). Where capacity binds, teacher forcing
    drops over the whole target, which no step-at-a-time decoder can."""
    params, src, smask, labels, _ = lm
    model = port_lm(params, moe_capacity_factor=8.0)
    s, m = torch.from_numpy(src), torch.from_numpy(smask)
    dec = torch.cat([torch.zeros(B, 1, dtype=torch.int32),
                     torch.from_numpy(labels[:, :-1])], 1)
    with torch.no_grad():
        enc = model.encode(s, attention_mask=m)
        want = model.decode_train(dec, enc, m)
        cache, steps = None, []
        for t in range(TGT):
            logits, cache = model.decode_step(dec[:, t:t + 1], t, enc, TGT,
                                              m, cache=cache)
            steps.append(logits[:, 0])
    np.testing.assert_allclose(torch.stack(steps, 1).numpy(), want.numpy(),
                               rtol=2e-4, atol=2e-5)


@pytest.fixture(scope="module")
def encoded(lm):
    """The JAX MoE model's encoder output and mask (numpy)."""
    params, src, smask, _, _ = lm
    jmodel = jt5.T5ForConditionalGeneration(jcfg.T5Size(**KW), **MOE)
    enc = jmodel.apply({"params": params}, input_ids=src,
                       attention_mask=smask, method=jmodel.encode)
    return jmodel, np.array(enc)


def test_greedy_and_one_beam_match_jax(lm, encoded):
    params, _, smask, _, _ = lm
    jmodel, enc = encoded
    L = 10
    want = np.asarray(jgen.greedy_decode(jmodel, params, enc, smask, L))
    want_beam = np.asarray(jgen.beam_search_decode(jmodel, params, enc,
                                                   smask, L, num_beams=1))
    model = port_lm(params)
    e, m = torch.from_numpy(enc), torch.from_numpy(smask)
    with torch.inference_mode():
        got = tgen.greedy_decode(model, e, m, L)
        beam = tgen.beam_search_decode(model, e, m, L, num_beams=1)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(beam.numpy(), want_beam)
    np.testing.assert_array_equal(beam.numpy(), got.numpy())


def test_speculative_matches_jax_speculative(lm, encoded):
    """Speculative decode verifies a chunk of draft + 1 tokens in one pass,
    routed at the chunk's capacity (ceil(2 * 4 * 1.25 / 4) = 3 slots an
    expert): a token may overflow where greedy's one-token step never
    does. JAX's speculative decode quantizes on the chunk the same way, so
    the port is held to it, tokens and counts; where either differs from
    greedy, that is the reason (ROADMAP C)."""
    params, _, smask, _, _ = lm
    jmodel, enc = encoded
    L, draft = 12, 3
    src = np.tile(np.arange(2, 8, dtype=np.int32), (B, 2))[:, :SRC]
    jtok, jpasses, jacc = jspec.speculative_greedy_decode_with_stats(
        jmodel, params, jnp.asarray(enc), jnp.asarray(smask), L, draft, 1,
        jnp.asarray(src))
    model = port_lm(params)
    with torch.inference_mode():
        tok, passes, acc = tspec.speculative_greedy_decode_with_stats(
            model, torch.from_numpy(enc), torch.from_numpy(smask), L, draft,
            1, torch.from_numpy(src))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    assert int(passes) == int(jpasses)
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))


# -- training -----------------------------------------------------------------


def _cascade_batch(cfg, seed, rows=4):
    g = np.random.default_rng(seed)
    S = cfg.swin.image_size
    batch = dict(
        images=g.integers(0, 256, (rows, S, S, 3), dtype=np.uint8),
        source_ids=g.integers(2, 512, (rows, 32)).astype(np.int32),
        source_mask=np.ones((rows, 32), np.int32),
        target_ids=g.integers(2, 512, (rows, TGT)).astype(np.int32),
        target_mask=np.ones((rows, TGT), np.int32))
    batch["source_mask"][1, 20:] = 0
    batch["target_mask"][2, 5:] = 0
    return batch


@pytest.fixture(scope="module")
def cascade_params():
    jc, _ = tp.configs(max_target_length=TGT, **MOE)
    return tp.jax_multimodal_params(jc, seed=0)


def test_trainer_step_matches_jax(cascade_params):
    from klab_multimodalmodel_tpu.train.trainer import Trainer as JaxTrainer
    from klab_multimodalmodel_tpu.utils import make_mesh
    from klab_multimodalmodel_tpu_torch.train.trainer import Trainer

    jc, tc = tp.configs(compute_dtype="float32", max_target_length=TGT,
                        **MOE)
    jt = JaxTrainer(jc, make_mesh((1, 1, 1), devices=jax.devices()[:1]),
                    num_epochs=1)
    state = tp.jax_train_state(jt, cascade_params)
    batch = _cascade_batch(jc, 0)
    jloss, jgrads = jax.jit(jax.value_and_grad(jt._loss_fn),
                            static_argnums=3)(state.params, batch,
                                              jax.random.PRNGKey(1), False)
    tt = Trainer(tc, device="cpu")
    tt.init_state(state_dict=convert_jax_params(cascade_params, tc))
    loss = tt.train_step(batch, torch.Generator().manual_seed(0))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=TOL)
    want = convert_jax_params(jax.tree.map(np.asarray, jgrads), tc)
    moe_leaves = [n for n in want if ".mlp." in n]
    assert len(moe_leaves) == 3 * 4  # 2 + 2 blocks, 3 tensors each
    for name in moe_leaves:
        g, w = tt.model.get_parameter(name).grad, want[name]
        err = float((g - w).abs().max())
        assert err <= TOL * float(w.abs().max()), (name, err)


def _phantom(batch, pad):
    """The loop's accumulation tail: real rows cycled, both masks zeroed."""
    n = len(batch["images"])
    idx = np.arange(n + pad) % n
    out = {k: v[idx].copy() for k, v in batch.items()}
    out["source_mask"][n:] = 0
    out["target_mask"][n:] = 0
    return out


def test_phantom_rows_change_no_loss_or_gradient(cascade_params):
    """Phantom rows (all masks zero) stay out of routing, capacity and the
    aux's group mean (the JAX package's test_moe.py:509, :560), at a
    capacity that binds."""
    _, tc = tp.configs(compute_dtype="float32", max_target_length=TGT,
                       **dict(MOE, moe_capacity_factor=0.5))
    from klab_multimodalmodel_tpu_torch.models.multimodal import (
        MultiModalModel)

    model = MultiModalModel(tc, device="cpu")
    model.load_state_dict(convert_jax_params(cascade_params, tc),
                          strict=True)
    batch = _cascade_batch(tc, 1)
    outs = []
    for b in (batch, _phantom(batch, 3)):
        t = {k: torch.from_numpy(v) for k, v in b.items()}
        model.zero_grad()
        out = model(t["images"].float() / 255, t["source_ids"],
                    t["target_ids"], t["source_mask"], t["target_mask"])
        out.loss.backward()
        outs.append((out, {n: p.grad.clone() for n, p in
                           model.named_parameters() if p.grad is not None}))
    (a, ga), (b, gb) = outs
    np.testing.assert_allclose(b.aux_loss.item(), a.aux_loss.item(),
                               rtol=1e-6)
    np.testing.assert_allclose(b.loss.item(), a.loss.item(), rtol=1e-6)
    for n in ga:
        torch.testing.assert_close(gb[n], ga[n], rtol=1e-5, atol=1e-7)


def test_train_runs_moe_with_a_padded_tail(tmp_path):
    """``train(config)`` with MoE, 3 loader batches into updates of 2 (the
    last padded with phantom rows): 2 updates, finite losses."""
    from klab_multimodalmodel_tpu_torch.data import (DataLoader,
                                                     SyntheticCaptionDataset)
    from klab_multimodalmodel_tpu_torch.text import ByteTokenizer
    from klab_multimodalmodel_tpu_torch.train.loop import train

    _, tc = tp.configs(kernels=False, compute_dtype="float32",
                       max_target_length=TGT, data_dir="synthetic",
                       result_dir=str(tmp_path), accumulation_steps=2,
                       num_epochs=1, **MOE)

    def loader(n):
        return DataLoader(SyntheticCaptionDataset(n=n, image_size=32),
                          ByteTokenizer(), global_batch_size=2,
                          max_source_length=tc.max_source_length,
                          max_target_length=TGT, seed=0)

    out = train(tc, loader(6), loader(2), resume=False, device="cpu")
    assert out["steps"] == 2
    losses = out["losses"]["train"]
    assert losses and all(np.isfinite(x) for x in losses)


# -- checkpoints --------------------------------------------------------------


def test_upcycle_matches_jax_bitwise(lm):
    params = lm[0]
    jdense = jt5.T5ForConditionalGeneration(jcfg.T5Size(**KW))
    ids = np.zeros((1, SRC), np.int32)
    dense = jax.tree.map(np.array, jax.jit(jdense.init)(
        jax.random.PRNGKey(4), ids, decoder_input_ids=ids)["params"])
    want = convert_t5_lm(jax.tree.map(np.asarray, jt5.upcycle_t5_params(
        dense, params)), T5Size(**KW))
    size = T5Size(**KW)
    got = tt5.upcycle_t5_params(
        {k: torch.tensor(v) for k, v in convert_t5_lm(dense, size).items()},
        {k: torch.tensor(v) for k, v in convert_t5_lm(params, size).items()})
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(got[k], torch.tensor(v)), k
    model = tt5.T5ForConditionalGeneration(size, device="cpu", **MOE)
    model.load_state_dict(got, strict=True)
    with pytest.raises(ValueError, match="dense source"):
        tt5.upcycle_t5_params(got | {"encoder.block.0.layer.1.DenseReluDense"
                                     ".wi.weight": torch.zeros(1)},
                              {"encoder.block.0.layer.1.mlp.router.weight":
                               torch.zeros(1)})


def _trainer(moe: bool, tmp_path=None):
    from klab_multimodalmodel_tpu_torch.train.trainer import Trainer

    _, tc = tp.configs(compute_dtype="float32", max_target_length=TGT,
                       **(MOE if moe else {}))
    t = Trainer(tc, device="cpu")
    t.init_state(torch.Generator().manual_seed(int(moe)))
    return t


def test_init_checkpoint_from_a_dense_checkpoint_upcycles(tmp_path):
    from klab_multimodalmodel_tpu_torch.checkpoint.io import (
        load_pretrained_params, save_pretrained)

    dense = _trainer(False)
    sd = {k: v for k, v in dense.model.state_dict().items()
          if k.startswith("transformer.")}
    save_pretrained(str(tmp_path), sd)
    moe = _trainer(True)
    fresh = {k: v.clone() for k, v in moe.model.state_dict().items()}
    assert load_pretrained_params(str(tmp_path), moe) == ["transformer"]
    got = moe.model.state_dict()
    for i in range(2):
        pre = f"transformer.encoder.block.{i}.layer.1."
        wi = sd[pre + "DenseReluDense.wi.weight"].t()
        for e in range(MOE["moe_experts"]):
            assert torch.equal(got[pre + "mlp.experts_wi"][e], wi)
            assert torch.equal(got[pre + "mlp.experts_wo"][e],
                               sd[pre + "DenseReluDense.wo.weight"].t())
        assert torch.equal(got[pre + "mlp.router.weight"],
                           fresh[pre + "mlp.router.weight"])
    name = "transformer.decoder.block.1.layer.0.SelfAttention.q.weight"
    assert torch.equal(got[name], sd[name])


@pytest.mark.parametrize("saved_moe", [False, True], ids=["dense_to_moe",
                                                          "moe_to_dense"])
def test_resume_across_the_dense_moe_boundary_raises(tmp_path, saved_moe):
    from klab_multimodalmodel_tpu_torch.checkpoint.io import (
        CheckpointManager)

    ck = CheckpointManager(str(tmp_path))
    ck.save("step_1", _trainer(saved_moe), {"epoch": 0})
    ck.wait()
    assert ck.load_metadata("step_1").get("moe", False) == saved_moe
    with pytest.raises(ValueError, match="dense/MoE boundary"):
        ck.restore("step_1", _trainer(not saved_moe))
    ck.restore("step_1", _trainer(saved_moe))  # the same kind resumes


# -- serving ------------------------------------------------------------------


def test_int8_leaves_router_and_experts_unquantized(lm, encoded):
    from klab_multimodalmodel_tpu_torch.infer.quantize import (
        quantize_for_decode)

    params, _, smask, _, _ = lm
    model = port_lm(params)
    q = quantize_for_decode(model)
    for name, mod in q.named_modules():
        if name.endswith(".mlp"):
            assert mod.router.weight.dtype == torch.bfloat16, name
            assert mod.experts_wi.dtype == torch.bfloat16, name
            assert not hasattr(mod.router, "qscale"), name
    assert q.encoder.block[0].layer[0]["SelfAttention"].q.weight.dtype == (
        torch.int8)
    with torch.inference_mode():
        tok = tgen.greedy_decode(q, torch.from_numpy(encoded[1]),
                                 torch.from_numpy(smask), 8)
    assert tok.shape == (B, 8) and (tok[:, 0] == 0).all()


def test_captioner_does_not_trim_source_buckets_under_moe():
    from klab_multimodalmodel_tpu_torch.infer.captioner import Captioner
    from klab_multimodalmodel_tpu_torch.text import ByteTokenizer

    widths = {}
    for moe in (False, True):
        cfg, sd = tp.port_cascade_state(kernels=False, max_source_length=64,
                                        **(MOE if moe else {}))
        cap = Captioner(cfg, sd, ByteTokenizer(), device="cpu")
        images = np.zeros((2, 32, 32, 3), np.uint8)
        enc, mask = cap._encode_prefill(images, None)
        widths[moe] = mask.shape[1]
        assert len(cap.caption(images)) == 2
    side = tp.TINY_SWIN["image_size"] // tp.TINY_SWIN["patch_size"] // 2
    # The COCO prompt's bytes fit the 32 bucket; MoE keeps all 64 columns.
    assert widths == {False: side * side + 32, True: side * side + 64}


def test_hf_export_refuses_an_moe_transformer(lm):
    from klab_multimodalmodel_tpu_torch.checkpoint.export_hf import (
        export_t5_lm)

    sd = port_lm(lm[0]).state_dict()
    with pytest.raises(ValueError, match="no HuggingFace T5"):
        export_t5_lm(sd, T5Size(**KW))
