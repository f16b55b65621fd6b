"""GPipe stages unsharded over pipe on a sharded mesh, over four gloo
ranks on the CPU, and checkpoints across the pipelined layouts.

One torchrun job of 4 ranks runs, one after the other:

* mesh (1, 2, 2, 1, 1, 1) with ``pipeline_stages`` 2: the one-process
  tick schedule of ``T5Stack._pipelined`` on every rank, its blocks FSDP2
  units of fsdp 2 and tensor-parallel over tensor 2 (each block gathered
  and resharded at every tick that runs it); two fp32 Adam updates from
  the same converted JAX weights, held against the JAX ``Trainer`` on the
  same mesh of the fake CPU devices at the tolerances of
  ``tests/test_spmd_equivalence.py``;
* (1, 1, 2, 1, 2, 1), tensor 2 x pipe 2, whose run restores the first
  run's checkpoint after its steps;
* (1, 2, 1, 1, 2, 1), fsdp 2 x pipe 2, at 4 + 4 blocks (two a stage), 4
  microbatches and ``remat='full'``: the recompute runs inside the
  written-out backward, under FSDP2's gathered blocks.

Each is held against the port's one-process ``Trainer`` within 1e-5
relative; the bytes each rank holds are ``per_rank_bytes``' reckoning;
each checkpoint restores bitwise into one process and into the other
layout.
"""

import pytest

import _torch_port as tp
import _torch_split as ts
import klab_multimodalmodel_tpu_torch.config as tcfg
from test_torch_pipe_sharded import (BASE, NPROC, SIZES,
                                     assert_held_bytes,
                                     assert_ranks_hold_their_stage)

FSDP_TENSOR = (1, 2, 2, 1, 1, 1)
TENSOR_PIPE = (1, 1, 2, 1, 2, 1)
FSDP_PIPE = (1, 2, 1, 1, 2, 1)
T5_4 = "t5-torchport-tiny-4layer-pipe-sharded"
KW4 = dict(tp.TINY_T5, num_layers=4, num_decoder_layers=4)
tcfg.register_t5_size(T5_4, tcfg.T5Size(**KW4))
JAX_RUNS = {"fsdp2_tensor2_stages2": dict(mesh_shape=FSDP_TENSOR)}
PORT_RUNS = {"tensor2_pipe2_restores": dict(
                 mesh_shape=TENSOR_PIPE, restore_run="fsdp2_tensor2_stages2"),
             "remat_m4": dict(mesh_shape=FSDP_PIPE, remat="full",
                              pipeline_microbatches=4,
                              transformer_model_name=T5_4)}
MESHES = {"fsdp2_tensor2_stages2": FSDP_TENSOR,
          "tensor2_pipe2_restores": TENSOR_PIPE, "remat_m4": FSDP_PIPE}


@pytest.fixture(scope="module")
def interpret():
    """The JAX package's Pallas kernels in interpret mode (the CPU)."""
    from klab_multimodalmodel_tpu.ops import set_interpret

    set_interpret(True)
    yield
    set_interpret(False)


@pytest.fixture(scope="module")
def runs(tmp_path_factory, interpret):
    sizes = dict(SIZES, t5_sizes=dict(SIZES["t5_sizes"], **{T5_4: KW4}))
    return ts.split_runs(tmp_path_factory.mktemp("pipe_fsdp"), FSDP_TENSOR,
                         BASE, JAX_RUNS, PORT_RUNS, sizes, None,
                         nproc=NPROC)


def test_stages_on_fsdp2_tensor2_match_jax(runs):
    """Two updates of the unsharded stages on fsdp 2 x tensor 2 against the
    JAX ``Trainer`` on the same mesh."""
    ts.assert_matches_jax(runs, "fsdp2_tensor2_stages2")


@pytest.mark.parametrize("name", [*JAX_RUNS, *PORT_RUNS])
def test_pipe_fsdp_trainer_matches_one_process(runs, name):
    """The same rows through one process: losses, eval losses, parameters
    and the optimizer's state within 1e-5 relative; under pipe, each rank
    holds its stage, and what a tensor x pipe group holds alike is
    bitwise equal across it."""
    ts.assert_matches_one_process(runs, name)
    if MESHES[name][4] > 1:
        assert_ranks_hold_their_stage(runs, name, MESHES[name])


@pytest.mark.parametrize("name", list(MESHES))
def test_pipe_fsdp_checkpoint_restores_in_one_process(runs, name):
    """Each layout's checkpoint restores bitwise into one process,
    optimizer state included."""
    got = runs["got"][name]
    trainer = ts.one_process_restore(runs, name)
    ts.assert_state_equal(trainer.model.state_dict(), got["params"])
    ts.assert_state_equal(trainer.full_optimizer_state_dict(),
                          got["optimizer"])


def test_pipe_checkpoint_restores_across_layouts(runs):
    """The fsdp 2 x tensor 2 run's checkpoint (stages at pipe 1), restored
    by the tensor 2 x pipe 2 run, gathers back bitwise: parameters and
    optimizer state."""
    got = runs["got"]["tensor2_pipe2_restores"]
    want = runs["got"]["fsdp2_tensor2_stages2"]
    ts.assert_state_equal(got["restored"], want["params"])
    ts.assert_state_equal(got["restored_optimizer"], want["optimizer"])


@pytest.mark.parametrize("name", list(MESHES))
def test_pipe_fsdp_held_bytes_are_the_reckoning(runs, name):
    """The parameter bytes each rank holds are ``per_rank_bytes``'
    reckoning for its pipe rank, reckoned without a process group."""
    assert_held_bytes(runs, name, MESHES[name])
