"""MoE under sequence parallelism (the ``seq`` axis with ``moe_experts``,
beside ``expert``, ``fsdp`` and ``tensor``): the ``Trainer`` over four
gloo ranks on the CPU, held against the JAX ``Trainer`` on the same mesh.

One torchrun job of 4 ranks runs, one after the other:

* mesh (1, 1, 1, 2, 1, 2): seq 2 x expert 2. The four ranks share the
  rows; rank (s, e) runs seq rank s's positions of every T5 stack and
  experts [2e, 2e + 2) of every MoE layer. Each routing group (a
  sequence) spans the seq ranks: a rank's slots are offset by the earlier
  seq rank's choices, and the tokens' gradient of its experts is summed
  over the expert group at its positions only. DDP all-reduces the
  gradients over the seq ranks of each expert slice;
* mesh (1, 2, 1, 2): fsdp 2 x seq 2, each fsdp rank its rows, the
  balance loss one mean over both fsdp ranks' groups;
* mesh (1, 1, 2, 2): tensor 2 x seq 2, rank (t, s) runs columns
  [t F/2, (t + 1) F/2) of every expert at seq rank s's positions.

All top-2 with both kernel flags on (their plain versions here), on the
all-gather path, two fp32 Adam updates from the same converted JAX
weights, held against the JAX ``Trainer`` on the same mesh of the fake CPU
devices (its Pallas kernels in interpret mode): losses within 2e-5
relative, parameters within rtol 5e-4 / atol 1e-6, the tolerances of
``tests/test_spmd_equivalence.py``; and against the port's one-process
``Trainer`` on the same rows: losses, eval losses, parameters and
optimizer state within 1e-5 relative. What the ranks of a seq group hold
is bitwise equal across it, and each rank holds ``per_rank_bytes``'
reckoning.
"""

import pytest

import _torch_port as tp
import _torch_split as ts
from test_torch_pipe_sharded import assert_held_bytes
from test_torch_seq_sharded import assert_seq_ranks_hold_alike

NPROC = 4
SEQ_EXPERT = (1, 1, 1, 2, 1, 2)
FSDP_SEQ = (1, 2, 1, 2)
TENSOR_SEQ = (1, 1, 2, 2)
MOE = dict(moe_experts=4, moe_top_k=2, moe_capacity_factor=1.25)
SIZES = dict(t5_sizes={tp.T5_NAMES["v10"][0]: tp.TINY_T5},
             swin_sizes={tp.SWIN_NAME: tp.TINY_SWIN})
BASE = dict(kernels=True, compute_dtype="float32", max_target_length=ts.TGT,
            batch_size=ts.B, **MOE)
JAX_RUNS = {"seq2_expert2": dict(mesh_shape=SEQ_EXPERT),
            "fsdp2_seq2": dict(mesh_shape=FSDP_SEQ),
            "tensor2_seq2": dict(mesh_shape=TENSOR_SEQ)}
MESHES = {name: kw["mesh_shape"] for name, kw in JAX_RUNS.items()}


@pytest.fixture(scope="module")
def interpret():
    """The JAX package's Pallas kernels in interpret mode (the CPU)."""
    from klab_multimodalmodel_tpu.ops import set_interpret

    set_interpret(True)
    yield
    set_interpret(False)


@pytest.fixture(scope="module")
def runs(tmp_path_factory, interpret):
    return ts.split_runs(tmp_path_factory.mktemp("moe_seq"), SEQ_EXPERT,
                         BASE, JAX_RUNS, {}, SIZES, None, nproc=NPROC)


@pytest.mark.parametrize("name", list(JAX_RUNS))
def test_moe_seq_trainer_matches_jax(runs, name):
    """Two updates against the JAX ``Trainer`` on the same mesh (its XLA
    partitioner routes each whole sequence at its global shape)."""
    ts.assert_matches_jax(runs, name)


@pytest.mark.parametrize("name", list(JAX_RUNS))
def test_moe_seq_trainer_matches_one_process(runs, name):
    """The same rows through one process: losses, eval losses, parameters
    and the optimizer's state within 1e-5 relative; the ranks of each seq
    group hold the same parameters and shards, bitwise."""
    ts.assert_matches_one_process(runs, name)
    assert_seq_ranks_hold_alike(runs, name, MESHES[name])


@pytest.mark.parametrize("name", list(JAX_RUNS))
def test_moe_seq_held_bytes_are_the_reckoning(runs, name):
    """The parameter bytes each rank holds (its bank slices under the
    expert and tensor axes, FSDP2's shards under fsdp) are
    ``per_rank_bytes``' reckoning, which the seq axis leaves as it is."""
    assert_held_bytes(runs, name, MESHES[name])
