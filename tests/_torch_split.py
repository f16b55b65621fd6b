"""What the pipe and expert tests of the port share: one gloo job of
``_torch_shard_worker.py`` (2 ranks, or ``nproc``) that runs every case of
a file in turn, the port's one-process runs of the same cases, and the
JAX ``Trainer``'s on the same mesh of the fake CPU devices.

``split_runs`` builds, for each case: its seeded initial weights (the
converted JAX weights for the cases held against JAX, a one-process
``init_state`` otherwise), one process's two updates, eval losses,
parameters and optimizer state, the split run (its ``local`` dumps per
rank, its whole state gathered to rank 0, a checkpoint it wrote, and for
the dropout case a one-process checkpoint it restored), and a ``train()``
of two epochs of two updates under the split mesh against one process's.
"""

import contextlib
import dataclasses
import json
import math

import numpy as np
import torch

import jax

import _torch_port as tp
from _torch_ddp_worker import Job, loaders
from klab_multimodalmodel_tpu.train.trainer import Trainer as JaxTrainer
from klab_multimodalmodel_tpu.utils import make_mesh as jax_make_mesh
from klab_multimodalmodel_tpu_torch.checkpoint.from_jax import (
    convert_jax_params)
from klab_multimodalmodel_tpu_torch.checkpoint.io import (
    CheckpointManager, read_whole, read_whole_optimizer)
from klab_multimodalmodel_tpu_torch.train import Trainer, train
from klab_multimodalmodel_tpu_torch.train.loop import dropout_seed
from test_torch_sharded import B, TGT, WORKER, make_batch

# Config fields that change a case's model (and so its seeded weights).
MODEL_KEYS = {"transformer_model_name", "language_model_name",
              "image_model_name", "moe_experts"}
JAX_LOSS_RTOL = 2e-5
JAX_PARAM_TOL = dict(rtol=5e-4, atol=1e-6)
TOL = 1e-5
LOOP_BATCH = 8


def batches(target: int = TGT) -> list:
    return [{k: torch.as_tensor(v[:, :target] if k.startswith("target")
                                else v) for k, v in make_batch(s).items()}
            for s in (0, 1)]


def jax_run(jc, mesh: tuple, params, rows) -> tuple[list, dict]:
    """Two updates of the JAX ``Trainer`` on ``mesh`` of the fake CPU
    devices: (losses, parameters)."""
    jt = JaxTrainer(jc, jax_make_mesh(
        mesh, devices=jax.devices()[:math.prod(mesh)]), num_epochs=1)
    state = tp.jax_train_state(jt, params)
    losses = []
    for b in rows:
        state, loss = jt.train_step(state, jt.device_put_batch(
            {k: np.asarray(v) for k, v in b.items()}),
            jax.random.PRNGKey(7))
        losses.append(float(loss))
    return losses, jax.tree.map(np.asarray, jax.device_get(state.params))


def jax_params(jc) -> dict:
    """Seeded JAX parameters of ``jc``'s cascade (its transformer in the
    pipelined layout under ``pipeline_stages``: initialized whole, then
    split into stages as the JAX package's ``pipeline_t5_params`` does)."""
    from klab_multimodalmodel_tpu.models.t5 import pipeline_t5_params

    flat = tp.jax_multimodal_params(
        dataclasses.replace(jc, pipeline_stages=1), seed=0)
    if jc.pipeline_stages == 1:
        return flat
    return dict(flat, transformer=jax.tree.map(np.asarray, pipeline_t5_params(
        flat["transformer"], jc.pipeline_stages)))


def split_runs(root, mesh: tuple, base: dict, jax_runs: dict,
               port_runs: dict, sizes: dict, loop: dict,
               nproc: int = 2) -> dict:
    """Every case of ``jax_runs`` and ``port_runs`` (name -> ``Config``
    overrides of ``base``) in one job of ``nproc`` ranks on ``mesh`` (or
    the case's own ``mesh_shape``; a case's ``restore_run`` names an
    earlier case whose checkpoint it restores after its steps, and its
    ``one_stream`` gives every data rank one dropout stream), and
    ``train()`` with ``loop``'s overrides (its ``mesh_shape``, or
    ``mesh``); a case's ``one_context`` (a context manager factory) wraps
    its one-process run; see the module doc."""
    jc, tc = tp.configs(**base)
    params = jax_params(jc)
    converted = convert_jax_params(params, tc)
    torch.save(converted, root / "converted.pt")
    # A JAX case whose overrides change the model has weights of its own.
    models, tcs = {}, {}
    for name, overrides in jax_runs.items():
        if set(overrides) & MODEL_KEYS:
            jc_r, tcs[name] = tp.configs(**dict(base, **{
                k: v for k, v in overrides.items() if k != "mesh_shape"}))
            models[name] = jax_params(jc_r)
            torch.save(convert_jax_params(models[name], tcs[name]),
                       root / f"{name}.converted.pt")
    job_runs, ones = [], {}
    cases = {**jax_runs, **port_runs}
    for name, overrides in cases.items():
        overrides = dict(overrides)
        restore_run = overrides.pop("restore_run", None)
        one_stream = overrides.pop("one_stream", False)
        one_context = overrides.pop("one_context", contextlib.nullcontext)
        run_mesh = overrides.pop("mesh_shape", mesh)
        _, cfg = tp.configs(**dict(base, **overrides))
        rows = batches(cfg.max_target_length)
        torch.save(rows, root / f"{name}.batches.pt")
        one = Trainer(dataclasses.replace(cfg, mesh_shape=(1, 1, 1)),
                      device="cpu")
        if name in jax_runs:
            init = root / (f"{name}.converted.pt" if name in models
                           else "converted.pt")
            one.init_state(state_dict=torch.load(init))
        else:
            one.init_state()
            init = root / f"{name}.init.pt"
            torch.save(one.model.state_dict(), init)
        gen = torch.Generator().manual_seed(dropout_seed(cfg.seed, 0))
        with one_context():
            ones[name] = dict(
                losses=[float(one.train_step(b, gen)) for b in rows],
                evals=[float(one.eval_step(b)) for b in rows],
                params={n: p.detach().clone()
                        for n, p in one.model.named_parameters()},
                optimizer=one.full_optimizer_state_dict(), config=cfg)
        run = dict(config=dataclasses.asdict(dataclasses.replace(
                       cfg, mesh_shape=run_mesh)),
                   init=str(init), batches=str(root / f"{name}.batches.pt"),
                   eval=str(root / f"{name}.batches.pt"),
                   result_dir=str(root / name), out=str(root / f"{name}.json"),
                   params=str(root / f"{name}.pt"),
                   local=str(root / f"{name}.local.{{rank}}.pt"),
                   held=str(root / f"{name}.held.{{rank}}.json"),
                   one_stream=one_stream)
        if restore_run is not None:
            run["restore"] = str(root / restore_run)
        elif "dropout" in name:
            CheckpointManager(str(root / "one_dropout")).save(
                f"step_{one.step}", one)
            run["restore"] = str(root / "one_dropout")
        job_runs.append(run)
    loop_cfg = loop_run = None
    if loop is not None:
        loop = dict(loop)
        loop_mesh = loop.pop("mesh_shape", mesh)
        loop_cfg = dataclasses.replace(
            tp.configs(**dict(base, **loop))[1], num_epochs=2,
            save_interval=1, cache_frozen_features=True,
            data_dir="synthetic", max_source_length=64,
            max_target_length=16, batch_size=LOOP_BATCH,
            mesh_shape=loop_mesh, result_dir=str(root / "loop"))
        loop_run = dict(n_train=16, n_val=8, global_batch=LOOP_BATCH)
        job_runs.append(dict(loop_run, loop=True,
                             config=dataclasses.asdict(loop_cfg),
                             out=str(root / "loop.json"),
                             params=str(root / "loop.{rank}.pt")))
    job = Job(root, job_runs, sizes, nproc=nproc, script=WORKER)

    jax_out = {}
    for name, overrides in jax_runs.items():
        overrides = dict(overrides)
        run_mesh = overrides.pop("mesh_shape", mesh)
        jax_out[name] = jax_run(dataclasses.replace(jc, **overrides),
                                run_mesh, models.get(name, params),
                                batches())
    loop_one = loop_got = None
    if loop_cfg is not None:
        one_cfg = dataclasses.replace(loop_cfg, mesh_shape=(1, 1, 1),
                                      result_dir=str(root / "loop_one"))
        loop_one = train(one_cfg, *loaders(one_cfg, loop_run, 0, 1),
                         resume=False, device="cpu")
    job.wait()
    got = {}
    for name in cases:
        with open(root / f"{name}.json") as f:
            got[name] = dict(json.load(f), **torch.load(root / f"{name}.pt"))
        got[name]["local"] = [torch.load(root / f"{name}.local.{r}.pt")
                              for r in range(nproc)]
        got[name]["held"] = []
        for r in range(nproc):
            with open(root / f"{name}.held.{r}.json") as f:
                got[name]["held"].append(json.load(f))
    if loop_cfg is not None:
        with open(root / "loop.json") as f:
            loop_got = json.load(f)
        loop_got["params"] = [torch.load(root / f"loop.{r}.pt")
                              for r in range(nproc)]
    return dict(root=root, tc=tc, tcs=tcs, jax=jax_out, one=ones, got=got,
                loop=loop_got, loop_one=loop_one, loop_cfg=loop_cfg,
                jax_params=params)


def assert_close_rel(got: torch.Tensor, want: torch.Tensor, name: str):
    rel = float((got.float() - want.float()).norm()
                / want.float().norm().clamp(min=1e-12))
    assert rel <= TOL, (name, rel)


def assert_matches_jax(runs: dict, name: str) -> None:
    """Losses and every parameter against the JAX ``Trainer``'s."""
    jlosses, jparams = runs["jax"][name]
    got = runs["got"][name]
    np.testing.assert_allclose(got["losses"], jlosses, rtol=JAX_LOSS_RTOL)
    want = convert_jax_params(jparams, runs["tcs"].get(name, runs["tc"]))
    assert set(got["params"]) == set(want)
    for pname, w in want.items():
        np.testing.assert_allclose(got["params"][pname].numpy(),
                                   np.asarray(w), err_msg=pname,
                                   **JAX_PARAM_TOL)


def assert_matches_one_process(runs: dict, name: str) -> None:
    """Losses, eval losses, parameters and optimizer state against one
    process's, within ``TOL`` relative (the optimizer's by name: the
    split run's one-process form)."""
    got, want = runs["got"][name], runs["one"][name]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=TOL)
    np.testing.assert_allclose(got["evals"], want["evals"], rtol=TOL)
    assert set(got["params"]) >= set(want["params"])
    for pname, w in want["params"].items():
        assert_close_rel(got["params"][pname], w, pname)
    opt_got, opt_want = got["optimizer"], want["optimizer"]
    assert opt_got["param_groups"] == opt_want["param_groups"]
    assert set(opt_got["state"]) == set(opt_want["state"])
    for i, st in opt_want["state"].items():
        assert set(opt_got["state"][i]) == set(st), i
        for k, v in st.items():
            g = opt_got["state"][i][k]
            if isinstance(v, torch.Tensor) and v.dim() > 0:
                assert g.shape == v.shape and g.dtype == v.dtype, (i, k)
                assert_close_rel(g, v, f"{i}.{k}")
            else:
                assert float(g) == float(v), (i, k)


def assert_state_equal(got: dict, want: dict) -> None:
    """Two state dicts (or optimizer state dicts) bitwise equal."""
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, dict):
            assert_state_equal(g, w)
        elif isinstance(w, torch.Tensor):
            assert g.dtype == w.dtype and torch.equal(g, w), k
        else:
            assert g == w, k


def one_process_restore(runs: dict, name: str) -> Trainer:
    """A one-process ``Trainer`` of case ``name`` that restored the split
    run's checkpoint."""
    cfg = dataclasses.replace(runs["one"][name]["config"],
                              mesh_shape=(1, 1, 1))
    trainer = Trainer(cfg, device="cpu")
    trainer.init_state()
    manager = CheckpointManager(str(runs["root"] / name))
    manager.restore(manager.latest(), trainer)
    return trainer


def assert_checkpoints_cross(runs: dict, name: str, dropout: str) -> None:
    """Case ``name``'s split checkpoint restores bitwise into one process,
    optimizer state included; the ``dropout`` case restored one process's
    checkpoint bitwise."""
    got = runs["got"][name]
    trainer = one_process_restore(runs, name)
    assert_state_equal(trainer.model.state_dict(), got["params"])
    assert_state_equal(trainer.full_optimizer_state_dict(), got["optimizer"])
    saved = (runs["root"] / "one_dropout" / "checkpoints"
             / f"step_{len(runs['one'][dropout]['losses'])}")
    restored = runs["got"][dropout]
    assert_state_equal(restored["restored"], read_whole(str(saved)))
    assert_state_equal(restored["restored_optimizer"],
                       read_whole_optimizer(str(saved)))


def assert_loop_matches_one_process(runs: dict) -> None:
    """``train()`` under the split mesh: per-epoch losses and
    ``min_val_loss`` are one process's, rank 0 wrote the checkpoints, and
    the last one restores into a one-process ``Trainer``."""
    got, one = runs["loop"], runs["loop_one"]
    assert got["steps"] == one["steps"] == 4
    for phase in ("train", "val"):
        np.testing.assert_allclose(got["losses"][phase],
                                   one["losses"][phase], rtol=TOL,
                                   err_msg=phase)
    np.testing.assert_allclose(got["min_val_loss"], one["min_val_loss"],
                               rtol=TOL)
    assert got["saves"] == [s["name"] for s in one["saves"]]
    cfg = dataclasses.replace(runs["loop_cfg"], mesh_shape=(1, 1, 1))
    trainer = Trainer(cfg, device="cpu")
    trainer.init_state()
    manager = CheckpointManager(cfg.result_dir)
    manager.restore(manager.latest(), trainer)
    whole = dict(trainer.model.named_parameters())
    for r, local in enumerate(got["params"]):
        for n, p in local.items():
            if n in whole and p.shape == whole[n].shape:
                assert torch.equal(whole[n].detach(), p), (r, n)
