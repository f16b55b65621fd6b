"""The expert and pipe splits beside data parallelism: one torchrun job of
4 gloo ranks on the CPU runs the ``Trainer`` at data 2 x expert 2 and at
data 2 x pipe 2 (each data rank draws half of every batch, and DDP
all-reduces the gradients over the 2 ranks of its stage's or its experts'
data group only), against one process on the same rows: losses, eval
losses and parameters within 1e-5 relative. The MoE run weighs its
balance loss 0: a data rank's balance loss is its own rows' (the one
difference from one process, as under plain DDP; ``train/trainer.py``).
Every rank holds the replicated parameters bitwise, and the ranks of one
expert slice its banks."""

import dataclasses
import json

import pytest
import torch

import _torch_port as tp
import _torch_split as ts
from _torch_ddp_worker import Job
from klab_multimodalmodel_tpu_torch.train import Trainer
from klab_multimodalmodel_tpu_torch.train.loop import dropout_seed

SIZES = dict(t5_sizes={tp.T5_NAMES["v10"][0]: tp.TINY_T5},
             swin_sizes={tp.SWIN_NAME: tp.TINY_SWIN})
BASE = dict(compute_dtype="float32", max_target_length=ts.TGT,
            batch_size=ts.B // 2)
RUNS = {"data2_expert2": ((2, 1, 1, 1, 1, 2), dict(
            moe_experts=4, moe_top_k=2, moe_aux_loss_weight=0.0)),
        "data2_pipe2": ((2, 1, 1, 1, 2, 1), dict(
            pipeline_stages=2, use_pallas_t5_attention=False))}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("split_ddp")
    rows = ts.batches()
    torch.save(rows, root / "batches.pt")
    job_runs, ones = [], {}
    for name, (mesh, flags) in RUNS.items():
        _, cfg = tp.configs(**dict(BASE, **flags))
        one = Trainer(dataclasses.replace(cfg, mesh_shape=(1, 1, 1)),
                      device="cpu")
        one.init_state()
        torch.save(one.model.state_dict(), root / f"{name}.init.pt")
        gen = torch.Generator().manual_seed(dropout_seed(cfg.seed, 0))
        ones[name] = dict(
            losses=[float(one.train_step(b, gen)) for b in rows],
            evals=[float(one.eval_step(b)) for b in rows],
            params={n: p.detach().clone()
                    for n, p in one.model.named_parameters()})
        job_runs.append(dict(
            config=dataclasses.asdict(dataclasses.replace(cfg,
                                                          mesh_shape=mesh)),
            init=str(root / f"{name}.init.pt"),
            batches=str(root / "batches.pt"), eval=str(root / "batches.pt"),
            result_dir=str(root / name), out=str(root / f"{name}.json"),
            params=str(root / f"{name}.pt"),
            local=str(root / f"{name}.local.{{rank}}.pt")))
    Job(root, job_runs, SIZES, nproc=4, script=ts.WORKER).wait()
    got = {}
    for name in RUNS:
        with open(root / f"{name}.json") as f:
            got[name] = dict(json.load(f), **torch.load(root / f"{name}.pt"))
        got[name]["local"] = [torch.load(root / f"{name}.local.{r}.pt")
                              for r in range(4)]
    return dict(one=ones, got=got)


@pytest.mark.parametrize("name", list(RUNS))
def test_split_beside_data_matches_one_process(runs, name):
    got, want = runs["got"][name], runs["one"][name]
    assert got["ddp_ranks"] == 2 and got["dp"] == [0, 2]
    torch.testing.assert_close(torch.tensor(got["losses"]),
                               torch.tensor(want["losses"]), rtol=ts.TOL,
                               atol=0)
    torch.testing.assert_close(torch.tensor(got["evals"]),
                               torch.tensor(want["evals"]), rtol=ts.TOL,
                               atol=0)
    for pname, w in want["params"].items():
        ts.assert_close_rel(got["params"][pname], w, pname)
    local = got["local"]
    for n in set(local[0]) & set(local[1]) & set(local[2]) & set(local[3]):
        if n.endswith((".experts_wi", ".experts_wo")):
            # Ranks 0 and 2 hold experts 0-1, ranks 1 and 3 experts 2-3.
            for r in range(4):
                assert torch.equal(local[r][n],
                                   got["params"][n][2 * (r % 2):][:2]), n
        else:
            assert all(torch.equal(local[0][n], local[r][n])
                       for r in range(1, 4)), n
