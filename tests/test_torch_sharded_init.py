"""Sharded init of the port: a partitioned ``Trainer`` builds its model on
the meta device, and each of 4 gloo ranks on the CPU materializes only its
pieces, drawing every parameter whole, one at a time, as one process draws
them (``Trainer.init_state``).

One torchrun job of 4 ranks runs ``init_state`` alone, on a seeded
generator, at seven layouts: data 2 x fsdp 2, data 2 x tensor 2, fsdp 2 x
tensor 2, fsdp 2 x pipe 2 (2 stages), MoE at data 2 x expert 2 and at
tensor 2 x expert 2 (4 experts), and seq 2 beside fsdp 2. For each:

* the parameters are on meta before ``init_state``;
* every rank's pieces (``Trainer.piece``) equal the same slices of one
  process's init, bitwise, and the pieces of the four ranks fill every
  parameter;
* the generator ends where one process's does;
* while the pieces are made (``to_empty`` and the draws; not the DDP
  buckets or the optimizer after), no allocation is larger than the
  largest whole parameter, and every parameter's whole temporary (and the
  helpers of a truncated normal's draw) is gone before the next
  parameter's is made (a ``TorchDispatchMode`` over the init);
* the Swin tower's rebuilt tables and masks equal one process's.
"""

import dataclasses
import math

import pytest
import torch

import _torch_port as tp
from _torch_ddp_worker import Job
from klab_multimodalmodel_tpu_torch.models.multimodal import MultiModalModel
from klab_multimodalmodel_tpu_torch.parallel.partitioning import piece_view
from klab_multimodalmodel_tpu_torch.train import Trainer

SEED = 11
MOE = dict(moe_experts=4, moe_top_k=2)
LAYOUTS = {
    "data2_fsdp2": ((2, 2, 1), {}),
    "data2_tensor2": ((2, 1, 2), {}),
    "fsdp2_tensor2": ((1, 2, 2), {}),
    "fsdp2_pipe2": ((1, 2, 1, 1, 2, 1), dict(pipeline_stages=2)),
    "moe_data2_expert2": ((2, 1, 1, 1, 1, 2), MOE),
    "moe_tensor2_expert2": ((1, 1, 2, 1, 1, 2), MOE),
    "fsdp2_seq2": ((1, 2, 1, 2), {}),
}
SIZES = dict(t5_sizes={tp.T5_NAMES["v11"][0]: tp.TINY_T5_V11},
             swin_sizes={tp.SWIN_NAME: tp.TINY_SWIN})
WORKER = __file__.replace("test_torch_sharded_init.py",
                          "_torch_shard_worker.py")


def config(layout: str):
    shape, extra = LAYOUTS[layout]
    # The untied v1.1 geometry: an LM head and gated MLPs too.
    return tp.configs("v11", kernels=False, frozen_param_dtype="bfloat16",
                      mesh_shape=shape, **extra)[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("sharded_init")
    job = Job(root, [dict(init_check=True, seed=SEED, out=str(
        root / f"{name}.{{rank}}.pt"), config=dataclasses.asdict(
            config(name))) for name in LAYOUTS], SIZES, nproc=4,
        script=WORKER)
    one = {}
    for name in LAYOUTS:
        cfg = dataclasses.replace(config(name), mesh_shape=(1, 1, 1))
        gen = torch.Generator().manual_seed(SEED)
        trainer = Trainer(cfg, device="cpu")
        trainer.init_state(gen)
        one[name] = dict(state=trainer.model.state_dict(),
                         buffers=dict(trainer.model.named_buffers()),
                         generator=gen.get_state())
    job.wait()
    got = {name: [torch.load(root / f"{name}.{r}.pt") for r in range(4)]
           for name in LAYOUTS}
    return dict(one=one, got=got)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_pieces_are_one_process_slices(runs, layout):
    one, ranks = runs["one"][layout], runs["got"][layout]
    covered = {n: torch.zeros(v.shape, dtype=torch.int32)
               for n, v in one["state"].items()}
    for r, got in enumerate(ranks):
        assert got["on_meta"], r
        for name, (piece, t) in got["pieces"].items():
            want = piece_view(one["state"][name], piece)
            assert t.dtype == want.dtype and torch.equal(t, want), (r, name)
            piece_view(covered[name], piece).add_(1)
    for name, n in covered.items():
        assert int(n.min()) >= 1, name  # every element on some rank


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_generator_and_buffers_are_one_process(runs, layout):
    one = runs["one"][layout]
    for got in runs["got"][layout]:
        assert torch.equal(got["generator"], one["generator"])
        assert got["buffers"].keys() == one["buffers"].keys()
        for name, b in one["buffers"].items():
            assert torch.equal(got["buffers"][name], b), name


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_init_holds_one_whole_parameter_at_most(runs, layout):
    largest = max(math.prod(v.shape) for v in runs["one"][layout][
        "state"].values())
    plan = list(MultiModalModel(config(layout), device="meta").init_plan())
    drawn = sum(init.draws for _, init in plan)
    for got in runs["got"][layout]:
        assert 0 < got["largest"] <= largest
        # A temporary for every parameter that draws (and for each held one
        # that does not), none of whose helpers outlive its draw, each made
        # once the previous one is gone.
        assert drawn <= got["draws"] <= len(plan) and got["stale"] == 0
