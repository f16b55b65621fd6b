"""The training options under sharding, over 2 gloo ranks on the CPU,
against the port's one-process ``Trainer`` on the same weights and rows
(itself held to the JAX package in ``test_torch_optim.py`` and
``test_torch_train*.py``).

One torchrun job of 2 ranks runs four layouts one after the other, each
2 updates at fp32 from the same seeded weights on the same 8-row global
batches, the T5 kernel flag on (the plain kernel versions on the CPU):

* ``Adafactor`` under fsdp 2: its factored statistics and block RMS are
  means over whole parameters, not over a rank's shard;
* ``AdamBf16Mu`` under fsdp 2;
* Adam under tensor 2 at dropout 0.1: every dropout mask is one
  process's (the MLP's and the attention's drawn at the full width, the
  kernels keyed on the global head), so the run equals the one-process
  run at dropout 0.1, and every parameter that no tensor rank splits (the
  norms, the relative-position tables, the Swin tower, ...) is bitwise
  equal on the two ranks;
* Adam under tensor 2 with the v1.1 geometry: gated ``wi_0`` / ``wi_1``
  and the untied, column-parallel LM head;
* ``train()`` under tensor 2 (the loop: each data rank's rows, its
  dropout stream, rank 0's checkpoints) with ``cache_frozen_features``,
  two epochs of the skewed synthetic rows (the second from the cache),
  against the one-process ``train()``: per-epoch losses and
  ``min_val_loss``.

Held: the losses within ``TOL`` relative and every parameter within
``TOL`` of its norm (see ``test_torch_sharded.py``).
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import _torch_port as tp
import klab_multimodalmodel_tpu_torch.config as tcfg
from _torch_ddp_worker import Job, loaders
from klab_multimodalmodel_tpu_torch.parallel.partitioning import (
    tensor_parallel)
from klab_multimodalmodel_tpu_torch.train import Trainer, train
from klab_multimodalmodel_tpu_torch.train.loop import dropout_seed
from test_torch_sharded import B, TGT, WORKER, make_batch

TOL = 1e-4
# The train() run's global batch: one data rank, read by both tensor ranks.
LOOP_BATCH = 8
DROP_T5 = "t5-torchport-tiny-dropout"
tcfg.register_t5_size(DROP_T5, tcfg.T5Size(**dict(tp.TINY_T5,
                                                  dropout_rate=0.1)))
V11 = tp.T5_NAMES["v11"][0]
SIZES = dict(t5_sizes={tp.T5_NAMES["v10"][0]: tp.TINY_T5,
                       DROP_T5: dict(tp.TINY_T5, dropout_rate=0.1),
                       V11: tp.TINY_T5_V11},
             swin_sizes={tp.SWIN_NAME: tp.TINY_SWIN})
RUNS = {
    "adafactor_fsdp2": dict(mesh_shape=(1, 2, 1), optimizer="adafactor"),
    "adam_bf16_mu_fsdp2": dict(mesh_shape=(1, 2, 1),
                               adam_mu_dtype="bfloat16"),
    "dropout_tensor2": dict(mesh_shape=(1, 1, 2),
                            language_model_name=DROP_T5,
                            transformer_model_name=DROP_T5),
    "gated_untied_tensor2": dict(mesh_shape=(1, 1, 2),
                                 language_model_name=V11,
                                 transformer_model_name=V11),
}


def _config(**overrides) -> tcfg.Config:
    kw = dict(compute_dtype="float32", max_target_length=TGT, batch_size=B)
    _, tc = tp.configs(**dict(kw, **overrides))
    return tc


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("sharded_options")
    batches = [{k: torch.as_tensor(v) for k, v in make_batch(s).items()}
               for s in (0, 1)]
    torch.save(batches, root / "batches.pt")
    job_runs, ones, inits = [], {}, {}
    for name, overrides in RUNS.items():
        cfg = _config(**overrides)
        one = Trainer(dataclasses.replace(cfg, mesh_shape=(1, 1, 1)),
                      device="cpu")
        one.init_state()
        init = {k: v.clone() for k, v in one.model.state_dict().items()}
        torch.save(init, root / f"{name}.init.pt")
        inits[name] = init
        job_runs.append(dict(
            config=dataclasses.asdict(cfg),
            init=str(root / f"{name}.init.pt"),
            batches=str(root / "batches.pt"), result_dir=str(root / name),
            out=str(root / f"{name}.json"), params=str(root / f"{name}.pt"),
            local=str(root / f"{name}.local.{{rank}}.pt")))
        ones[name] = one
    loop_cfg = _config(num_epochs=2, cache_frozen_features=True,
                       data_dir="synthetic", max_source_length=64,
                       max_target_length=80, batch_size=LOOP_BATCH,
                       mesh_shape=(1, 1, 2),
                       result_dir=str(root / "loop"))
    loop_run = dict(n_train=16, n_val=8, global_batch=LOOP_BATCH)
    job_runs.append(dict(loop_run, loop=True,
                         config=dataclasses.asdict(loop_cfg),
                         out=str(root / "loop.json")))
    job = Job(root, job_runs, SIZES, nproc=2, script=WORKER)
    one_cfg = dataclasses.replace(loop_cfg, mesh_shape=(1, 1, 1),
                                  batch_size=LOOP_BATCH,
                                  result_dir=str(root / "loop_one"))
    loop_one = train(one_cfg, *loaders(one_cfg, loop_run, 0, 1),
                     resume=False, device="cpu")
    want = {}
    for name, one in ones.items():
        gen = torch.Generator().manual_seed(dropout_seed(one.config.seed, 0))
        losses = [float(one.train_step(b, gen)) for b in batches]
        want[name] = dict(losses=losses, params={
            n: p.detach() for n, p in one.model.named_parameters()})
    job.wait()
    with open(root / "loop.json") as f:
        loop = json.load(f)
    got = {}
    for name in RUNS:
        with open(root / f"{name}.json") as f:
            got[name] = dict(json.load(f), **torch.load(root / f"{name}.pt"))
        got[name]["local"] = [torch.load(root / f"{name}.local.{r}.pt")
                              for r in range(2)]
    return dict(want=want, got=got, init=inits, loop=loop,
                loop_one=loop_one)


@pytest.mark.parametrize("name", list(RUNS))
def test_sharded_option_matches_one_process(runs, name):
    want, got = runs["want"][name], runs["got"][name]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=TOL)
    for pname, w in want["params"].items():
        rel = float((got["params"][pname] - w).norm()
                    / w.norm().clamp(min=1e-12))
        assert rel <= TOL, (pname, rel)


def test_replicated_parameters_stay_equal_across_tensor_ranks(runs):
    """At dropout 0.1 under tensor 2 (fsdp 1: each rank's shard is the
    whole parameter): every parameter that is not split over the tensor
    ranks is bitwise equal on both, the relative-position tables and the
    norm scales included, after 2 updates that moved them."""
    r0, r1 = runs["got"]["dropout_tensor2"]["local"]
    names = [n for n in r0 if not tensor_parallel(n)]
    assert set(names) == set(r0) == set(r1)
    assert any("relative_attention_bias" in n for n in names)
    assert any("layer_norm" in n for n in names)
    init = runs["init"]["dropout_tensor2"]
    for n in names:
        assert torch.equal(r0[n], r1[n]), n
    moved = [n for n in names if n.startswith("transformer.")
             and not torch.equal(r0[n], init[n])]
    assert any("relative_attention_bias" in n for n in moved)


def test_train_loop_under_tensor_parallelism(runs):
    """``train()`` over a tensor group: the ranks read the same rows, and
    its per-epoch losses (the second epoch from the frozen-feature cache)
    and ``min_val_loss`` are the one-process run's."""
    got, one = runs["loop"], runs["loop_one"]
    assert got["steps"] == one["steps"] == 4
    for phase in ("train", "val"):
        np.testing.assert_allclose(got["losses"][phase],
                                   one["losses"][phase], rtol=TOL,
                                   err_msg=phase)
    assert got["min_val_loss"] == pytest.approx(one["min_val_loss"],
                                                rel=TOL)
    # Rank 0 wrote the one process's checkpoints, every rank gathering.
    assert got["saves"] == [s["name"] for s in one["saves"]]
    assert "best" in got["saves"]
