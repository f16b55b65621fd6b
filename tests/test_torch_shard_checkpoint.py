"""Per-shard checkpoints of the port (``checkpoint/io.py``): each rank
writes the pieces it is the lowest rank to hold, rank 0 the index, and any
layout restores any other's, each rank reading only the stored pieces that
overlap its own.

One torchrun job of 4 gloo ranks on the CPU:

* saves after one Adam update at fsdp 2 x tensor 2 (from converted JAX
  weights), at fsdp 2 x expert 2 (MoE, 4 experts) and at tensor 2 x pipe 2
  (2 stages);
* restores each at fsdp 4, and the first also under DDP over data 4 and
  at data 2 x fsdp 2 (HSDP); restores the fsdp-4 MoE and pipe checkpoints
  so written back into fsdp 2 x expert 2 and tensor 2 x pipe 2; the
  state then held, gathered, equals the saved one bitwise, and so does
  the checkpoint each restoring layout writes again; each rank reads
  exactly the files whose pieces overlap its own (at fsdp 4 from fsdp 2 x
  tensor 2, fewer than all);
* resumes the fsdp 2 x tensor 2 checkpoint at fsdp 4 and takes the second
  update there: the halted run's losses and parameters are the JAX
  ``Trainer``'s unbroken two updates on the fake CPU devices' (1, 2, 2)
  mesh, at ``_torch_split``'s tolerances, as ``tests/test_multiprocess.py``
  holds the JAX package's resume across process counts;
* loads a pretrained file into fsdp 2 x tensor 2, and a dense one
  sparse-upcycled into an MoE model at tensor 2 x expert 2: bitwise one
  process's same load;
* kills one rank's write of a save: every rank's ``wait()`` raises and
  ``latest()`` still names the checkpoint before; then saves again and
  every rank exits, without ``wait()``, once the save is in place:
  ``latest()`` names it.

And in this process: each checkpoint restores bitwise into one process;
every stored piece is stored once, so the stored tensors' bytes are one
process's state's.
"""

import dataclasses
import json
import math

import numpy as np
import pytest
import torch

import _torch_port as tp
import _torch_split as ts
from _torch_ddp_worker import Job
from klab_multimodalmodel_tpu_torch.checkpoint.from_jax import (
    convert_jax_params)
from klab_multimodalmodel_tpu_torch.checkpoint.io import (
    CheckpointManager, PieceReader, load_pretrained_params, read_whole,
    read_whole_optimizer, save_pretrained)
from klab_multimodalmodel_tpu_torch.train import Trainer

MOE = dict(moe_experts=4, moe_top_k=2)
SAVES = {"fsdp2_tensor2": ((1, 2, 2), {}),
         "moe_fsdp2_expert2": ((1, 2, 1, 1, 1, 2), MOE),
         "pipe2_tensor2": ((1, 1, 2, 1, 2, 1), dict(pipeline_stages=2))}
RESTORES = {"fsdp4_from_fsdp2_tensor2": ("fsdp2_tensor2", (1, 4, 1)),
            "data4_from_fsdp2_tensor2": ("fsdp2_tensor2", (4, 1, 1)),
            "fsdp4_from_moe": ("moe_fsdp2_expert2", (1, 4, 1)),
            "fsdp4_from_pipe": ("pipe2_tensor2", (1, 4, 1)),
            "hsdp_from_fsdp2_tensor2": ("fsdp2_tensor2", (2, 2, 1)),
            "moe_from_fsdp4": ("fsdp4_from_moe", (1, 2, 1, 1, 1, 2)),
            "pipe_from_fsdp4": ("fsdp4_from_pipe", (1, 1, 2, 1, 2, 1))}
LOADS = {"pretrained_fsdp2_tensor2": ((1, 2, 2), {}),
         "upcycled_tensor2_expert2": ((1, 1, 2, 1, 1, 2), MOE)}
SIZES = dict(t5_sizes={tp.T5_NAMES["v10"][0]: tp.TINY_T5},
             swin_sizes={tp.SWIN_NAME: tp.TINY_SWIN})
WORKER = __file__.replace("test_torch_shard_checkpoint.py",
                          "_torch_shard_worker.py")


def config(shape, extra):
    return dataclasses.replace(tp.configs(
        kernels=False, compute_dtype="float32", max_target_length=ts.TGT,
        batch_size=8, **extra)[1], mesh_shape=shape)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("shard_checkpoint")
    jc = tp.configs(kernels=False, compute_dtype="float32",
                    max_target_length=ts.TGT)[0]
    params = tp.jax_multimodal_params(jc, seed=0)
    init = convert_jax_params(params, config((1, 1, 1), {}))
    torch.save(init, root / "init.pt")
    pretrained = save_pretrained(str(root / "pretrained"), init)
    rows = ts.batches()
    torch.save(rows[:1], root / "first.pt")
    torch.save(rows[1:], root / "second.pt")
    torch.save([], root / "none.pt")

    def run(name, shape, extra, batches, **kw):
        return dict(kw, config=dataclasses.asdict(config(shape, extra)),
                    batches=str(root / batches),
                    result_dir=str(root / name), out=str(root / f"{name}.json"),
                    params=str(root / f"{name}.pt"))
    job_runs = [run(n, s, e, "first.pt",
                    init=str(root / "init.pt") if not e else None)
                for n, (s, e) in SAVES.items()]
    for n, (saved, shape) in RESTORES.items():
        job_runs.append(run(
            n, shape, SAVES[RESTORES.get(saved, (saved,))[0]][1],
            "second.pt" if n.startswith("fsdp4_from_fsdp2") else "none.pt",
            resume=str(root / saved), reads=str(root / f"{n}.{{rank}}.json")))
    for n, (shape, extra) in LOADS.items():
        job_runs.append(run(n, shape, extra, "none.pt",
                            pretrained=pretrained))
    job_runs.append(dict(interrupt=2, config=dataclasses.asdict(
        config((1, 2, 2), {})), result_dir=str(root / "interrupted"),
        out=str(root / "interrupted.{rank}.json")))
    job = Job(root, job_runs, SIZES, nproc=4, script=WORKER)
    jax_losses, jax_params = ts.jax_run(jc, (1, 2, 2), params, rows)

    one = {}
    for n, (shape, extra) in LOADS.items():
        t = Trainer(config((1, 1, 1), extra), device="cpu")
        t.init_state()
        load_pretrained_params(pretrained, t)
        one[n] = t.model.state_dict()
    job.wait()
    got = {r["result_dir"].rsplit("/", 1)[1]: dict(
        json.load(open(r["out"])), **torch.load(r["params"]))
        for r in job_runs if "interrupt" not in r}
    reads = {n: [json.load(open(root / f"{n}.{r}.json")) for r in range(4)]
             for n in RESTORES}
    interrupted = [json.load(open(root / f"interrupted.{r}.json"))
                   for r in range(4)]
    return dict(root=root, got=got, reads=reads, one=one,
                interrupted=interrupted, tc=config((1, 1, 1), {}),
                jax=(jax_losses, jax_params))


def checkpoint(runs, name):
    manager = CheckpointManager(str(runs["root"] / name))
    return manager.path(manager.latest())


@pytest.mark.parametrize("name", list(RESTORES))
def test_restore_on_another_layout_is_bitwise(runs, name):
    saved = checkpoint(runs, RESTORES[name][0])
    got = runs["got"][name]
    ts.assert_state_equal(got["resumed"], read_whole(saved))
    ts.assert_state_equal(got["resumed_optimizer"],
                          read_whole_optimizer(saved))
    ts.assert_state_equal(read_whole(saved),
                          runs["got"][RESTORES[name][0]]["params"])
    if not got["losses"]:
        # Saved again, untouched, by the restoring layout's own pieces.
        again = checkpoint(runs, name)
        ts.assert_state_equal(read_whole(again), read_whole(saved))
        ts.assert_state_equal(read_whole_optimizer(again),
                              read_whole_optimizer(saved))


@pytest.mark.parametrize("name", list(RESTORES))
def test_each_rank_reads_only_overlapping_files(runs, name):
    ranks = runs["reads"][name]
    for r in ranks:
        assert r["read"] == r["want"]
    if name == "fsdp4_from_fsdp2_tensor2":
        # An fsdp-4 chunk lies in one fsdp-2 chunk: half the files.
        assert all(len(r["read"]) < len(r["stored"]) for r in ranks)


@pytest.mark.parametrize("name", list(SAVES))
def test_restore_in_one_process_and_pieces_stored_once(runs, name):
    shape, extra = SAVES[name]
    saved = checkpoint(runs, name)
    t = Trainer(config((1, 1, 1), extra), device="cpu")
    t.init_state()
    CheckpointManager(str(runs["root"] / name)).restore(
        saved.rsplit("/", 1)[1], t)
    ts.assert_state_equal(t.model.state_dict(), read_whole(saved))
    ts.assert_state_equal(t.optimizer.state_dict()["state"],
                          read_whole_optimizer(saved)["state"])
    one = sum(v.numel() * v.element_size()
              for v in t.model.state_dict().values())
    one += sum(v.numel() * v.element_size()
               for st in t.optimizer.state.values() for v in st.values()
               if isinstance(v, torch.Tensor))
    reader = PieceReader(saved)
    files = {p["file"] for e in reader.entries.values()
             for p in e.get("pieces", [])}
    stored = sum(v.numel() * v.element_size() for f in files
                 for v in torch.load(f"{saved}/{f}").values())
    assert stored == one
    assert len(files) == math.prod(shape) or name.startswith("moe")


def test_halted_run_resumed_on_another_layout_matches_jax(runs):
    jlosses, jparams = runs["jax"]
    first = runs["got"]["fsdp2_tensor2"]["losses"]
    second = runs["got"]["fsdp4_from_fsdp2_tensor2"]["losses"]
    np.testing.assert_allclose(first + second, jlosses,
                               rtol=ts.JAX_LOSS_RTOL)
    got = runs["got"]["fsdp4_from_fsdp2_tensor2"]["params"]
    for name, w in convert_jax_params(jparams, runs["tc"]).items():
        np.testing.assert_allclose(got[name].float().numpy(),
                                   np.asarray(w, np.float32), err_msg=name,
                                   **ts.JAX_PARAM_TOL)


@pytest.mark.parametrize("name", list(LOADS))
def test_pretrained_load_is_one_process(runs, name):
    ts.assert_state_equal(runs["got"][name]["params"], runs["one"][name])


def test_interrupted_save_leaves_no_checkpoint_on_any_rank(runs):
    for r, got in enumerate(runs["interrupted"]):
        assert got["raised"] is not None, r
        assert got["latest"] == "step_1", r
    assert not (runs["root"] / "interrupted" / "checkpoints"
                / "step_2").exists()


def test_save_is_committed_without_wait(runs):
    # The ranks exited once step_3 was in place, none calling wait().
    assert all(got["committed"] for got in runs["interrupted"])
    manager = CheckpointManager(str(runs["root"] / "interrupted"))
    assert manager.latest() == "step_3"
    ts.assert_state_equal(read_whole(manager.path("step_3")),
                          read_whole(manager.path("step_1")))
    ts.assert_state_equal(read_whole_optimizer(manager.path("step_3")),
                          read_whole_optimizer(manager.path("step_1")))
