"""The port's optimizers against optax, as the JAX package builds them
(``train/optim.py``): Adafactor against ``optax.adafactor(learning_rate,
multiply_by_parameter_scale=False)`` and Adam with a bf16 first moment
against ``optax.adam(..., mu_dtype=bfloat16)``, over five steps of the same
seeded gradients, the optax update jitted as the JAX ``Trainer`` runs it.

The tree: a factored leaf (256 x 384), leaves too small to factor (64 x 32,
a vector) and a scanned-stack leaf (3, 256, 128), which the port holds as
three per-layer tensors named as a T5 stack's blocks: Adafactor must factor
them per layer and clip their update by the RMS of all three together, as
``clip_by_block_rms`` clips the one JAX leaf. The parameters start at 0, so
what they hold after five steps is the sum of the updates, held per leaf
against its largest value. Adafactor: 1e-6 (fp32 summation order). Adam with
a bf16 first moment: 1e-4, the stored moments equal but for at most 1e-4 of
them (one bf16 ulp apart). XLA fuses optax's fp32 arithmetic into
multiply-adds, which round once where torch rounds twice, so a moment near a
bf16 rounding boundary can round the other way; and it computes the bias
correction 1 - b2^t with a pow one fp32 ulp off torch's at t = 3, which the
subtraction from 1 magnifies to 2e-5 of it. A bf16 moment against an fp32
one moves the parameters by more than 1e-3, so 1e-4 still tells the two
apart (checked)."""

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp
import optax

import klab_multimodalmodel_tpu_torch.config as tcfg
from klab_multimodalmodel_tpu_torch.train.optim import (
    Adafactor, AdamBf16Mu, jax_leaf_groups, make_optimizer)

STEPS, LR, TOL = 5, 1e-2, 1e-6
TOL_ADAM_BF16_MU = dict(params=1e-4, moments=1e-4)
JAX_SHAPES = {"shared": (256, 384), "proj": (64, 32), "norm": (100,),
              "stack": (3, 256, 128)}
STACK = "transformer.encoder.block.{}.layer.0.SelfAttention.q.weight"
PORT_NAMES = {"shared": ["transformer.shared.weight"],
              "proj": ["vision_projection.weight"],
              "norm": ["transformer.encoder.final_layer_norm.weight"],
              "stack": [STACK.format(i) for i in range(3)]}


def _model() -> nn.Module:
    """A module whose parameters carry ``PORT_NAMES``, all zero."""
    root = nn.Module()
    for leaf, names in PORT_NAMES.items():
        shape = JAX_SHAPES[leaf][1:] if leaf == "stack" else JAX_SHAPES[leaf]
        for name in names:
            mod = root
            *path, last = name.split(".")
            for part in path:
                if not hasattr(mod, part):
                    mod.add_module(part, nn.Module())
                mod = getattr(mod, part)
            mod.register_parameter(last, nn.Parameter(torch.zeros(shape)))
    return root


def _grads(step: int) -> dict:
    g = np.random.default_rng(100 + step)
    return {k: (g.standard_normal(s) * (0.1 if k == "norm" else 1.0)).astype(
        np.float32) for k, s in JAX_SHAPES.items()}


def _run_both(tx, config, model=None):
    """The optax transform and the port's optimizer for ``config`` over
    STEPS steps from zero parameters (``model``'s, or a new ``_model()``):
    (JAX leaves, port tensors by leaf, the optax state, the port's
    optimizer)."""
    params = {k: jnp.zeros(s, jnp.float32) for k, s in JAX_SHAPES.items()}
    state = tx.init(params)
    update = jax.jit(tx.update)
    model = _model() if model is None else model
    opt, sched = make_optimizer(config, model, num_epochs=1)
    port = dict(model.named_parameters())
    for step in range(STEPS):
        grads = _grads(step)
        upd, state = update(jax.tree.map(jnp.asarray, grads), state, params)
        params = optax.apply_updates(params, upd)
        for leaf, names in PORT_NAMES.items():
            for i, name in enumerate(names):
                g = grads[leaf][i] if leaf == "stack" else grads[leaf]
                port[name].grad = torch.from_numpy(np.array(g))
        opt.step()
        sched.step()
    return params, _by_leaf(lambda name: port[name].detach()), state, opt


def _by_leaf(get) -> dict:
    """{JAX leaf: the port's value of it as numpy}, the stack's three
    tensors stacked."""
    return {leaf: torch.stack([get(n).float() for n in names]).numpy()
            if leaf == "stack" else get(names[0]).float().numpy()
            for leaf, names in PORT_NAMES.items()}


def _worst(want: dict, got: dict) -> float:
    return max(float(np.abs(got[k] - np.asarray(want[k], np.float32)).max()
                     / np.abs(np.asarray(want[k], np.float32)).max())
               for k in got)


def test_adafactor_matches_optax():
    config = tcfg.Config(optimizer="adafactor", lr=LR)
    tx = optax.adafactor(learning_rate=LR, multiply_by_parameter_scale=False)
    params, port, _, _ = _run_both(tx, config)
    assert _worst(params, port) <= TOL
    # The stacked leaf's three tensors are one clipping block.
    opt, _ = make_optimizer(config, _model(), 1)
    assert isinstance(opt, Adafactor)
    assert sorted(len(g["params"]) for g in opt.param_groups) == [1, 1, 1, 3]


def test_adafactor_clips_the_stacked_leaf_as_one_block():
    """The stack's update is clipped: its RMS before the clip is above 1 on
    step 1 only if the block is taken whole (a per-tensor clip would leave
    the smaller two alone), so the two ways give different results."""
    config = tcfg.Config(optimizer="adafactor", lr=LR)
    model = _model()
    opt, _ = make_optimizer(config, model, 1)
    names = PORT_NAMES["stack"]
    port = dict(model.named_parameters())
    for i, name in enumerate(names):
        # Layer 0 takes a gradient whose scaled update is far above RMS 1
        # after the first step's factoring; layers 1 and 2 are tiny.
        g = torch.full((256, 128), 1.0)
        g[0, 0] = 1e3 if i == 0 else 1.0
        port[name].grad = g
    opt.step()
    moved = [float(port[n].detach().abs().max()) for n in names]
    tx = optax.adafactor(learning_rate=LR, multiply_by_parameter_scale=False)
    leaf = jnp.stack([jnp.asarray(port[n].grad.numpy()) for n in names])
    upd, _ = tx.update({"s": leaf}, tx.init({"s": jnp.zeros_like(leaf)}),
                       {"s": jnp.zeros_like(leaf)})
    want = [float(jnp.abs(upd["s"][i]).max()) for i in range(3)]
    np.testing.assert_allclose(moved, want, rtol=TOL)


def test_adam_bf16_mu_matches_optax():
    config = tcfg.Config(adam_mu_dtype="bfloat16", lr=LR)
    tx = optax.adam(learning_rate=LR, b1=0.9, b2=0.999, eps=1e-8,
                    mu_dtype=jnp.bfloat16)
    model = _model()
    params, port, state, opt = _run_both(tx, config, model)
    assert isinstance(opt, AdamBf16Mu)
    assert _worst(params, port) <= TOL_ADAM_BF16_MU["params"]
    mu = _by_leaf(lambda n: opt.state[model.get_parameter(n)]["mu"])
    for leaf, want in state[0].mu.items():
        assert mu[leaf].dtype == np.float32 and want.dtype == jnp.bfloat16
        off = float((mu[leaf] != np.asarray(want, np.float32)).mean())
        assert off <= TOL_ADAM_BF16_MU["moments"], (leaf, off)
    # An fp32 first moment moves the parameters measurably elsewhere.
    fp32_mu, _, _, _ = _run_both(optax.adam(LR, 0.9, 0.999, 1e-8), config)
    assert _worst(fp32_mu, port) > 10 * TOL_ADAM_BF16_MU["params"]


def test_adam_bf16_mu_stores_the_moment_in_bf16():
    w = nn.Parameter(torch.zeros(4, 4))
    opt = AdamBf16Mu([w], lr=LR)
    w.grad = torch.ones(4, 4)
    opt.step()
    assert opt.state[w]["mu"].dtype == torch.bfloat16
    assert opt.state[w]["nu"].dtype == torch.float32
    assert w.dtype == torch.float32


@pytest.mark.parametrize("names,groups", [
    (["transformer.encoder.block.0.a", "transformer.encoder.block.1.a",
      "transformer.decoder.block.0.a", "image_model.encoder.layers.0.blocks."
      "1.attention.self.query.weight", "image_model.encoder.layers.0.blocks."
      "0.attention.self.query.weight"],
     [["transformer.encoder.block.0.a", "transformer.encoder.block.1.a"],
      ["transformer.decoder.block.0.a"],
      ["image_model.encoder.layers.0.blocks.1.attention.self.query.weight"],
      ["image_model.encoder.layers.0.blocks.0.attention.self.query.weight"]]),
])
def test_jax_leaf_groups(names, groups):
    """T5 blocks of one stack group by parameter; Swin blocks, each its own
    JAX leaf, do not."""
    assert jax_leaf_groups(names) == groups


def test_adam_bf16_mu_chunks_change_nothing():
    """The update runs over chunks of the parameter list: chunks of a few
    tensors give the same bits as one chunk of all."""
    results = []
    for chunk in (AdamBf16Mu.chunk_elements, 3000):
        model = _model()
        opt = AdamBf16Mu(model.parameters(), lr=LR)
        opt.chunk_elements = chunk
        for step in range(2):
            for i, p in enumerate(model.parameters()):
                p.grad = torch.from_numpy(np.random.default_rng(
                    step * 10 + i).standard_normal(p.shape).astype(
                        np.float32))
            opt.step()
        results.append([p.detach().clone() for p in model.parameters()])
    assert all(torch.equal(a, b) for a, b in zip(*results))
