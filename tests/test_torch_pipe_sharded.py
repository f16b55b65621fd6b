"""GPipe stages on a sharded mesh (the ``pipe`` axis beside ``fsdp`` and
``tensor``): the ``Trainer`` and ``train()`` over four gloo ranks on the
CPU.

One torchrun job of 4 ranks runs, one after the other:

* mesh (1, 2, 1, 1, 2, 1): fsdp 2 x pipe 2. Each fsdp rank holds its
  rows and runs its microbatches of them; pipe rank s holds stage s's
  blocks, FSDP2 units of its two fsdp ranks, and every other parameter
  sharded over them too;
* mesh (1, 1, 2, 1, 2, 1): tensor 2 x pipe 2. The four ranks share the
  rows; rank (t, s) runs heads and d_ff columns t of stage s's blocks, and
  shifts whole activations to rank (t, s + 1);

both at the tiny 2 + 2-block transformer (a block a stage), 2
microbatches, the Swin kernel on (its plain version here) and the T5
kernel off (the JAX package refuses it with stages), two fp32 Adam
updates from the same converted JAX weights, held against the JAX
``Trainer`` on the same mesh of the fake CPU devices: losses within 2e-5
relative, parameters within rtol 5e-4 / atol 1e-6, the tolerances of
``tests/test_spmd_equivalence.py``. Then, at fsdp 2 x pipe 2:

* dropout 0.1 with one dropout stream on every data rank: each rank draws
  its rows of one process's masks (``T5Stack.set_batch_share``), so the
  run equals one process's; it then restores a one-process checkpoint;
* Adafactor, whose clipping block over a stack's blocks sums its squares
  over the pipe group, each gradient gathered whole over fsdp first;

and ``train()`` with ``cache_frozen_features`` at fsdp 2 x pipe 2, two
epochs of two updates, against one process's ``train()``.

Each is held against the port's one-process ``Trainer`` (both stages in
tick order) on the same rows too: losses, eval losses, parameters and
optimizer state within 1e-5 relative; every parameter that a tensor x
pipe group holds alike is bitwise equal across it and each rank holds
its stage's blocks only; the bytes a rank holds are ``per_rank_bytes``'
reckoning; each checkpoint restores bitwise into one process.
"""

import pytest
import torch

import _torch_port as tp
import _torch_split as ts
import klab_multimodalmodel_tpu_torch.config as tcfg
from klab_multimodalmodel_tpu_torch.models.multimodal import MultiModalModel
from klab_multimodalmodel_tpu_torch.parallel.partitioning import (
    per_rank_bytes, stack_layers, stage_for_path)
from klab_multimodalmodel_tpu_torch.train.optim import trainable_names
from klab_multimodalmodel_tpu_torch.utils.mesh import (DEFAULT_AXIS_NAMES,
                                                       axis_groups)

NPROC = 4
FSDP_PIPE = (1, 2, 1, 1, 2, 1)
TENSOR_PIPE = (1, 1, 2, 1, 2, 1)
DROP_T5 = "t5-torchport-tiny-dropout-pipe-sharded"
tcfg.register_t5_size(DROP_T5, tcfg.T5Size(**dict(tp.TINY_T5,
                                                  dropout_rate=0.1)))
SIZES = dict(t5_sizes={tp.T5_NAMES["v10"][0]: tp.TINY_T5,
                       DROP_T5: dict(tp.TINY_T5, dropout_rate=0.1)},
             swin_sizes={tp.SWIN_NAME: tp.TINY_SWIN})
BASE = dict(kernels=True, use_pallas_t5_attention=False,
            compute_dtype="float32", max_target_length=ts.TGT,
            batch_size=ts.B, pipeline_stages=2, pipeline_microbatches=2)
JAX_RUNS = {"fsdp2_pipe2": dict(mesh_shape=FSDP_PIPE),
            "tensor2_pipe2": dict(mesh_shape=TENSOR_PIPE)}
PORT_RUNS = {"dropout": dict(mesh_shape=FSDP_PIPE, one_stream=True,
                             transformer_model_name=DROP_T5),
             "adafactor": dict(mesh_shape=FSDP_PIPE, optimizer="adafactor")}
MESHES = {"fsdp2_pipe2": FSDP_PIPE, "tensor2_pipe2": TENSOR_PIPE,
          "dropout": FSDP_PIPE, "adafactor": FSDP_PIPE}


@pytest.fixture(scope="module")
def interpret():
    """The JAX package's Pallas kernels in interpret mode (the CPU)."""
    from klab_multimodalmodel_tpu.ops import set_interpret

    set_interpret(True)
    yield
    set_interpret(False)


@pytest.fixture(scope="module")
def runs(tmp_path_factory, interpret):
    return ts.split_runs(tmp_path_factory.mktemp("pipe_sharded"), FSDP_PIPE,
                         BASE, JAX_RUNS, PORT_RUNS, SIZES,
                         dict(mesh_shape=FSDP_PIPE), nproc=NPROC)


def assert_ranks_hold_their_stage(runs: dict, name: str, mesh: tuple):
    """Each rank holds its pipe coordinate's stage of the blocks and every
    parameter outside the stages; what the ranks of a tensor x pipe group
    hold alike (outside the stages, and not split over tensor) is bitwise
    equal across it."""
    got = runs["got"][name]
    local, whole = got["local"], got["params"]
    layers = stack_layers(whole)
    for r, held in enumerate(local):
        stage = r // mesh[5] % mesh[4]
        blocks = {n for n in held if stage_for_path(n, layers, 2) is not None}
        assert blocks and all(stage_for_path(n, layers, 2) == stage
                              for n in blocks), (r, sorted(blocks)[:3])
    for group in axis_groups(mesh, [2, 3, 4, 5]):
        first = local[group[0]]
        for r in group[1:]:
            for n in set(first) & set(local[r]):
                if stage_for_path(n, layers, 2) is None:
                    assert torch.equal(local[r][n], first[n]), (r, n)


@pytest.mark.parametrize("name", list(JAX_RUNS))
def test_pipe_sharded_trainer_matches_jax(runs, name):
    """Two updates against the JAX ``Trainer`` on the same mesh (its
    stages over the mesh's pipe axis, their blocks over fsdp or tensor)."""
    ts.assert_matches_jax(runs, name)


@pytest.mark.parametrize("name", [*JAX_RUNS, *PORT_RUNS])
def test_pipe_sharded_trainer_matches_one_process(runs, name):
    """The same rows through one process: losses, eval losses, parameters
    and the optimizer's state within 1e-5 relative (at dropout 0.1 too:
    each fsdp rank's rows of one process's masks; Adafactor's clipping
    blocks summed over the stages); each rank holds its stage; each
    microbatch of each stack shifted once a step."""
    ts.assert_matches_one_process(runs, name)
    assert_ranks_hold_their_stage(runs, name, MESHES[name])
    assert runs["got"][name]["shifts"] == 2 * 2 * 2  # steps x stacks x M


@pytest.mark.parametrize("name", list(JAX_RUNS))
def test_pipe_sharded_checkpoints_restore_in_one_process(runs, name):
    """Each layout's checkpoint restores bitwise into one process,
    optimizer state included; the dropout run (fsdp 2 x pipe 2) restored
    one process's checkpoint bitwise."""
    ts.assert_checkpoints_cross(runs, name, "dropout")


def test_train_loop_under_fsdp2_pipe2(runs):
    """``train()`` at fsdp 2 x pipe 2 (each fsdp rank its chunk of the
    rows, the second epoch from the feature cache): one process's
    per-epoch losses, and the last checkpoint restores into one
    process."""
    ts.assert_loop_matches_one_process(runs)


@pytest.mark.parametrize("name", [*JAX_RUNS, *PORT_RUNS])
def test_pipe_sharded_held_bytes_are_the_reckoning(runs, name):
    """The parameter bytes each rank holds (its stage's blocks and the
    rest, in FSDP2's shards and tensor slices) are ``per_rank_bytes``'
    reckoning for its pipe rank, reckoned without a process group."""
    assert_held_bytes(runs, name, MESHES[name])


def assert_held_bytes(runs: dict, name: str, mesh: tuple) -> None:
    cfg = runs["one"][name]["config"]
    model = MultiModalModel(cfg, device="meta")
    names = trainable_names(model, cfg)
    shapes = [(n, tuple(p.shape), n in names)
              for n, p in model.named_parameters()]
    sizes = dict(zip(DEFAULT_AXIS_NAMES, mesh))
    for held in runs["got"][name]["held"]:
        want = per_rank_bytes(shapes, sizes, pipe_rank=held["coordinate"][4])
        assert held["params"] == want["params"], held
