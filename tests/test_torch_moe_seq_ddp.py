"""MoE under sequence parallelism alone (mesh (1, 1, 1, 2), DDP over data
x seq): the ``Trainer`` over two gloo ranks on the CPU, held against the
JAX ``Trainer`` on the same mesh.

One torchrun job of 2 ranks: both ranks hold the rows and the whole
parameters, each runs its half of every T5 stack's positions; every
routing group spans both ranks (the capacity of the full length, the
slots of seq rank 1 offset by seq rank 0's choices), and each rank's
balance loss is its positions' share of the whole, which DDP's gradient
all-reduce over the two ranks adds up. Top-2 with both kernel flags on
(their plain versions here), on the all-gather path, two fp32 Adam
updates from the same converted JAX weights: against the JAX ``Trainer``
(its Pallas kernels in interpret mode) losses within 2e-5 relative and
parameters within rtol 5e-4 / atol 1e-6; against the port's one-process
``Trainer`` losses, eval losses, parameters and optimizer state within
1e-5 relative, and the two ranks' parameters bitwise alike.
"""

import pytest

import _torch_port as tp
import _torch_split as ts
from test_torch_moe_seq import BASE, SIZES
from test_torch_seq_sharded import assert_seq_ranks_hold_alike

SEQ = (1, 1, 1, 2)
JAX_RUNS = {"seq2": dict(mesh_shape=SEQ)}


@pytest.fixture(scope="module")
def interpret():
    """The JAX package's Pallas kernels in interpret mode (the CPU)."""
    from klab_multimodalmodel_tpu.ops import set_interpret

    set_interpret(True)
    yield
    set_interpret(False)


@pytest.fixture(scope="module")
def runs(tmp_path_factory, interpret):
    return ts.split_runs(tmp_path_factory.mktemp("moe_seq_ddp"), SEQ, BASE,
                         JAX_RUNS, {}, SIZES, None, nproc=2)


def test_moe_seq_ddp_trainer_matches_jax(runs):
    """Two updates against the JAX ``Trainer`` on the same mesh."""
    ts.assert_matches_jax(runs, "seq2")


def test_moe_seq_ddp_trainer_matches_one_process(runs):
    """The same rows through one process: losses, eval losses, parameters
    and the optimizer's state within 1e-5 relative; both seq ranks hold
    the same parameters, bitwise; DDP spans both ranks."""
    ts.assert_matches_one_process(runs, "seq2")
    assert_seq_ranks_hold_alike(runs, "seq2", SEQ)
    assert runs["got"]["seq2"]["ddp_ranks"] == 2
