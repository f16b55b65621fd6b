"""Activation checkpointing (``remat``) of the trainable transformer's
blocks. With dropout at rate 0.1 in the transformer (the kernel path draws a
seed per attention call, the plain path a mask per dropout), the backward's
recompute must draw what the forward drew: the step's loss and every
gradient equal those without remat, bitwise, under the same generator seed,
and the generator ends the step where it would without remat. The step-1
loss against the JAX ``Trainer`` with ``remat='full'``: see
test_torch_train_storage.py."""

import pytest
import torch

import _torch_port as tp
from klab_multimodalmodel_tpu_torch.train.trainer import Trainer
from test_torch_train import TGT, make_batch
from test_torch_train_options import DROP_T5


def _step(remat, kernels):
    """(loss, gradients, the generator's state after the step, the calls of
    the transformer's blocks) of one dropout step in fp32 with ``remat``,
    from the port's seeded initial weights."""
    _, tc = tp.configs(kernels=kernels, compute_dtype="float32",
                       max_target_length=TGT, transformer_model_name=DROP_T5,
                       remat=remat)
    tt = Trainer(tc, device="cpu")
    tt.init_state(torch.Generator().manual_seed(0))
    calls = []
    for stack in (tt.model.transformer.encoder, tt.model.transformer.decoder):
        for blk in stack.block:
            blk.register_forward_pre_hook(lambda *_: calls.append(1))
    gen = torch.Generator().manual_seed(5)
    loss = tt.train_step(make_batch(tc, 6), gen)
    grads = {n: p.grad for n, p in tt.model.named_parameters()
             if p.grad is not None}
    return loss, grads, gen.get_state(), len(calls)


@pytest.mark.parametrize("kernels", [True, False], ids=["kernels", "plain"])
@pytest.mark.parametrize("remat", ["full", "dots_saveable"])
def test_remat_step_equals_the_step_without(remat, kernels):
    loss, grads, state, calls = _step("", kernels)
    r_loss, r_grads, r_state, r_calls = _step(remat, kernels)
    assert r_calls == 2 * calls  # each block's forward, then its recompute
    assert torch.equal(r_loss, loss)
    assert r_grads.keys() == grads.keys() and len(grads) > 20
    for name, g in grads.items():
        assert torch.equal(r_grads[name], g), name
    assert torch.equal(r_state, state)


def test_remat_replays_the_generator():
    """Without the replay the recompute would draw new masks: a checkpointed
    block that drops at rate 0.5 gives the gradient of the forward's mask."""
    from klab_multimodalmodel_tpu_torch.models.t5 import _remat_block

    class Drop(torch.nn.Module):
        calls = 0

        def forward(self, x, generator=None, scale=1.0):
            Drop.calls += 1
            keep = torch.rand(x.shape, generator=generator) < 0.5
            return torch.where(keep, x * x * scale, 0.0)

    x = torch.linspace(1.0, 2.0, 64, requires_grad=True)
    for remat in ("full", "dots_saveable"):
        gen = torch.Generator().manual_seed(0)
        y = _remat_block(Drop(), remat, x, gen, scale=3.0)
        after = gen.get_state()
        (dx,) = torch.autograd.grad(y.sum(), x)
        kept = y != 0
        assert torch.equal(dx, torch.where(kept, 6.0 * x, 0.0).detach())
        assert torch.equal(gen.get_state(), after)
    assert Drop.calls == 4  # two forwards and two recomputes
