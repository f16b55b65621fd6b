"""Sequence parallelism beside FSDP2 and tensor parallelism (the ``seq``
axis with ``fsdp`` and ``tensor``): the ``Trainer`` over four gloo ranks
on the CPU, held against the JAX ``Trainer`` on the same mesh.

One torchrun job of 4 ranks runs, one after the other:

* mesh (1, 2, 1, 2): fsdp 2 x seq 2, the all-gather path with both kernel
  flags on (the plain kernel versions at ``q_offset``). Each fsdp rank
  holds its rows and its FSDP2 shards; its two seq ranks hold the same
  shards and split every T5 stack's positions, and their reduced
  gradients are summed over the seq group;
* mesh (1, 1, 2, 2): tensor 2 x seq 2, the all-gather path with both
  kernel flags on. Rank (t, s) runs heads ``[2 t, 2 t + 2)`` of the
  transformer's four at seq rank s's positions: the plain kernels at
  ``head_offset`` and ``q_offset`` at once; the frozen text tower runs
  whole over tensor at ``q_offset`` only;
* mesh (1, 1, 2, 2) with ``--seq_attention ring`` and the T5 kernel off:
  the ring over each tensor rank's heads.

Each takes two fp32 Adam updates from the same converted JAX weights and
is held against the JAX ``Trainer`` on the same mesh of the fake CPU
devices (its Pallas kernels in interpret mode): losses within 2e-5
relative, parameters within rtol 5e-4 / atol 1e-6, the tolerances of
``tests/test_spmd_equivalence.py``; and against the port's one-process
``Trainer`` on the same rows: losses, eval losses, parameters and
optimizer state within 1e-5 relative. What the ranks of a seq group hold
is bitwise equal across it.
"""

import pytest
import torch

import _torch_port as tp
import _torch_split as ts
from klab_multimodalmodel_tpu_torch.utils.mesh import axis_groups

NPROC = 4
FSDP_SEQ = (1, 2, 1, 2)
TENSOR_SEQ = (1, 1, 2, 2)
SIZES = dict(t5_sizes={tp.T5_NAMES["v10"][0]: tp.TINY_T5},
             swin_sizes={tp.SWIN_NAME: tp.TINY_SWIN})
BASE = dict(kernels=True, compute_dtype="float32", max_target_length=ts.TGT,
            batch_size=ts.B)
JAX_RUNS = {"fsdp2_seq2_allgather": dict(mesh_shape=FSDP_SEQ),
            "tensor2_seq2_allgather": dict(mesh_shape=TENSOR_SEQ),
            "tensor2_seq2_ring": dict(mesh_shape=TENSOR_SEQ,
                                      seq_attention="ring",
                                      use_pallas_t5_attention=False)}
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
    return ts.split_runs(tmp_path_factory.mktemp("seq_sharded"), FSDP_SEQ,
                         BASE, JAX_RUNS, {}, SIZES, None, nproc=NPROC)


def assert_seq_ranks_hold_alike(runs: dict, name: str, mesh: tuple):
    """What the ranks of each seq group hold (their FSDP2 shards of what
    no tensor rank splits) is bitwise equal across the group."""
    local = runs["got"][name]["local"]
    for group in axis_groups(mesh, [3]):
        first = local[group[0]]
        for r in group[1:]:
            assert set(local[r]) == set(first)
            for n, p in first.items():
                assert torch.equal(local[r][n], p), (r, n)


@pytest.mark.parametrize("name", list(JAX_RUNS))
def test_seq_sharded_trainer_matches_jax(runs, name):
    """Two updates against the JAX ``Trainer`` on the same mesh: its
    positions over seq, its rows and shards over fsdp, its heads over
    tensor; the ring's run turned the ring, the all-gather runs did
    not."""
    ts.assert_matches_jax(runs, name)
    # The text tower's 2 and the transformer's 4 self-attentions: 1
    # exchange forward (the frozen tower's) or 1 forward and 2 backward;
    # 2 steps, then 2 evals.
    assert runs["got"][name]["ring_exchanges"] == (
        2 * (2 + 4 * 3) + 2 * (2 + 4) if name.endswith("ring") else 0)


@pytest.mark.parametrize("name", list(JAX_RUNS))
def test_seq_sharded_trainer_matches_one_process(runs, name):
    """The same rows through one process: losses, eval losses, parameters
    and the optimizer's state within 1e-5 relative; the seq ranks of each
    group hold the same shards, bitwise."""
    ts.assert_matches_one_process(runs, name)
    assert_seq_ranks_hold_alike(runs, name, MESHES[name])

