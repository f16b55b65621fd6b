"""Sharded training of the port (FSDP2 over data x fsdp, tensor parallelism
over tensor) over 4 gloo ranks on the CPU, against the JAX package's
``Trainer`` on a one-device mesh (the JAX package's own tests show its
sharded step equals that one), as ``test_torch_ddp.py`` holds the data
axis.

One torchrun job of 4 ranks runs two layouts one after the other: mesh
``(1, 2, 2)`` (fsdp 2 x tensor 2: the T5 stacks' heads, d_ff and vocab
split over 2 tensor ranks, every parameter sharded over 2 fsdp ranks)
and ``(2, 2, 1)`` (HSDP: replicated over data 2, sharded over fsdp 2).
Each takes 2 Adam updates at fp32 on the same 8-row global batches from
the same converted JAX weights (the second layout loads them as a
pretrained checkpoint over its seeded weights), the T5 kernel flag on
(the port's plain kernel versions on the CPU, with the head offset and the
per-head bias gradient of each tensor rank), then writes a checkpoint; the
second layout then restores the first's. Meanwhile JAX takes the same 2 updates
once (kernel flags off: its plain reference), for both layouts.

Held: the losses within ``TOL`` relative; every updated parameter within
``TOL`` of its norm (an element whose near-zero gradient flips sign under
rounding moves by 2 lr, which an elementwise bound would catch); each
checkpoint restores bitwise into one process, and the first layout's
restores bitwise into the second.
"""

import dataclasses

import numpy as np
import optax
import pytest
import torch

import jax

import _torch_port as tp
from _torch_ddp_worker import Job
from klab_multimodalmodel_tpu.train.trainer import Trainer as JaxTrainer
from klab_multimodalmodel_tpu.utils import make_mesh
from klab_multimodalmodel_tpu_torch.checkpoint.from_jax import (
    convert_jax_params)
from klab_multimodalmodel_tpu_torch.checkpoint.io import (
    CheckpointManager, save_pretrained)
from klab_multimodalmodel_tpu_torch.train import Trainer

TOL = 1e-4
B, SRC, TGT = 8, 32, 8
LAYOUTS = {"fsdp2_tensor2": (1, 2, 2), "data2_fsdp2": (2, 2, 1)}
SIZES = dict(t5_sizes={tp.T5_NAMES["v10"][0]: tp.TINY_T5},
             swin_sizes={tp.SWIN_NAME: tp.TINY_SWIN})
WORKER = __file__.replace("test_torch_sharded.py", "_torch_shard_worker.py")


def make_batch(seed: int) -> dict:
    """Seeded images, prompts with padded rows and captions with a padded
    target row, as ``test_torch_train.make_batch`` makes them."""
    g = np.random.default_rng(seed)
    S = tp.TINY_SWIN["image_size"]
    batch = dict(
        images=g.integers(0, 256, (B, S, S, 3), dtype=np.uint8),
        source_ids=g.integers(2, 512, (B, SRC)).astype(np.int32),
        source_mask=np.ones((B, SRC), np.int32),
        target_ids=g.integers(2, 512, (B, TGT)).astype(np.int32),
        target_mask=np.ones((B, TGT), np.int32))
    batch["source_mask"][1, 20:] = 0
    batch["source_mask"][6, 9:] = 0
    batch["target_mask"][2, 5:] = 0
    return batch


def jax_step(jt, state, batch):
    """The JAX ``Trainer``'s update at dropout 0 in one jitted function."""
    loss, grads = jax.value_and_grad(jt._loss_fn)(state.params, batch, None,
                                                  True)
    updates, opt_state = jt.tx.update(grads, state.opt_state, state.params)
    return loss, state.replace(step=state.step + 1,
                               params=optax.apply_updates(state.params,
                                                          updates),
                               opt_state=opt_state)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("sharded")
    jc, tc = tp.configs(kernels=False, compute_dtype="float32",
                        max_target_length=TGT)
    params = tp.jax_multimodal_params(jc, seed=0)
    init = convert_jax_params(params, tc)
    torch.save(init, root / "init.pt")
    pretrained = save_pretrained(str(root / "pretrained"), init)
    batches = [make_batch(s) for s in (0, 1)]
    torch.save([{k: torch.as_tensor(v) for k, v in b.items()}
                for b in batches], root / "batches.pt")
    config = dataclasses.asdict(dataclasses.replace(
        tc, use_pallas_t5_attention=True, batch_size=B))
    job_runs = []
    for i, (name, shape) in enumerate(LAYOUTS.items()):
        job_runs.append(dict(
            config=dict(config, mesh_shape=shape), init=str(root / "init.pt"),
            pretrained=pretrained if i else None,
            batches=str(root / "batches.pt"), result_dir=str(root / name),
            out=str(root / f"{name}.json"), params=str(root / f"{name}.pt"),
            restore=str(root / "fsdp2_tensor2") if i else None))
    job = Job(root, job_runs, SIZES, nproc=4, script=WORKER)

    jt = JaxTrainer(jc, make_mesh((1, 1, 1), devices=jax.devices()[:1]),
                    num_epochs=1)
    state = tp.jax_train_state(jt, params)
    step = jax.jit(lambda st, b: jax_step(jt, st, b))
    jlosses = []
    for b in batches:
        loss, state = step(state, b)
        jlosses.append(float(loss))
    jparams = convert_jax_params(jax.tree.map(np.asarray, state.params), tc)

    job.wait()
    import json

    out = {}
    for name in LAYOUTS:
        with open(root / f"{name}.json") as f:
            out[name] = dict(json.load(f), **torch.load(root / f"{name}.pt"))
    return dict(root=root, tc=dataclasses.replace(tc, batch_size=B),
                jax_losses=jlosses, jax_params=jparams, init=init, out=out)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_sharded_layout_matches_jax(runs, layout):
    got = runs["out"][layout]
    assert got["step"] == 2
    assert got["dp"][1] == LAYOUTS[layout][0] * LAYOUTS[layout][1]
    np.testing.assert_allclose(got["losses"], runs["jax_losses"], rtol=TOL)
    moved = 0
    for name, want in runs["jax_params"].items():
        p = got["params"][name]
        assert p.shape == want.shape, name
        rel = float((p - want).norm() / want.norm().clamp(min=1e-12))
        assert rel <= TOL, (name, rel)
        moved += not torch.equal(want, runs["init"][name])
    assert moved > 0


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_sharded_checkpoint_restores_in_one_process(runs, layout):
    """The files rank 0 wrote are one process's: a one-process ``Trainer``
    restores them (model, optimizer, step) and holds the gathered
    parameters bitwise."""
    trainer = Trainer(runs["tc"], device="cpu")
    trainer.init_state(state_dict=runs["init"])
    manager = CheckpointManager(str(runs["root"] / layout))
    manager.restore(manager.latest(), trainer)
    assert trainer.step == 2
    gathered = runs["out"][layout]["params"]
    state = trainer.model.state_dict()
    assert set(state) == set(gathered)
    for name, value in state.items():
        assert torch.equal(value, gathered[name]), name
    moments = trainer.optimizer.state_dict()["state"]
    assert len(moments) == sum(p.requires_grad
                               for p in trainer.model.parameters())
    assert all(int(s["step"]) == 2 for s in moments.values())


def test_checkpoint_restores_in_another_layout(runs):
    """The fsdp 2 x tensor 2 checkpoint restored under data 2 x fsdp 2 and
    gathered again: bitwise the parameters that wrote it."""
    restored = runs["out"]["data2_fsdp2"]["restored"]
    wrote = runs["out"]["fsdp2_tensor2"]["params"]
    assert set(restored) == set(wrote)
    for name, value in wrote.items():
        assert torch.equal(restored[name], value), name
