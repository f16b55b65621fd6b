"""MoE under FSDP2 and tensor parallelism without an expert axis, over
four gloo ranks on the CPU, checkpoints across the sharded MoE layouts,
and the six-axis rank layout without a process group.

One torchrun job of 4 ranks runs, one after the other:

* mesh (2, 2, 1, 1, 1, 1): HSDP with MoE. Four ranks of different rows;
  every bank whole in FSDP2's shards, replicated over data 2, and the
  balance loss one mean over the four ranks' groups (each rank's share of
  it);
* mesh (1, 2, 2, 1, 1, 1): fsdp 2 x tensor 2 with MoE. A tensor rank runs
  its d_ff columns of all four experts, and the tensor group sums the
  partial combine;

both top-2 with both kernel flags on (their plain versions here), two
fp32 Adam updates from the same converted JAX weights, held against the
JAX ``Trainer`` on the same mesh of the fake CPU devices (its Pallas
kernels in interpret mode) at the tolerances of
``tests/test_spmd_equivalence.py``; then (1, 1, 2, 1, 1, 2), whose run
restores the (1, 2, 2, 1, 1, 1) run's checkpoint after its steps. Each is
held against the port's one-process ``Trainer`` within 1e-5 relative,
and each checkpoint restores bitwise into one process and into the other
layout.
"""

import pytest
import torch

import _torch_split as ts
from klab_multimodalmodel_tpu_torch.models.multimodal import MultiModalModel
from klab_multimodalmodel_tpu_torch.parallel.partitioning import (
    per_rank_bytes)
from klab_multimodalmodel_tpu_torch.train.optim import trainable_names
from klab_multimodalmodel_tpu_torch.utils.mesh import (DEFAULT_AXIS_NAMES,
                                                       Mesh, axis_groups)
from test_torch_moe_sharded import (BASE, NPROC, SIZES,
                                    assert_ranks_hold_their_part)

DATA_FSDP = (2, 2, 1, 1, 1, 1)
FSDP_TENSOR = (1, 2, 2, 1, 1, 1)
TENSOR_EXPERT = (1, 1, 2, 1, 1, 2)
JAX_RUNS = {"data2_fsdp2": dict(mesh_shape=DATA_FSDP),
            "fsdp2_tensor2": dict(mesh_shape=FSDP_TENSOR)}
PORT_RUNS = {"tensor2_expert2_restores": dict(mesh_shape=TENSOR_EXPERT,
                                              restore_run="fsdp2_tensor2")}
MESHES = {"data2_fsdp2": DATA_FSDP, "fsdp2_tensor2": FSDP_TENSOR,
          "tensor2_expert2_restores": TENSOR_EXPERT}


@pytest.fixture(scope="module")
def interpret():
    """The JAX package's Pallas kernels in interpret mode (the CPU)."""
    from klab_multimodalmodel_tpu.ops import set_interpret

    set_interpret(True)
    yield
    set_interpret(False)


@pytest.fixture(scope="module")
def runs(tmp_path_factory, interpret):
    return ts.split_runs(tmp_path_factory.mktemp("moe_fsdp"), DATA_FSDP,
                         BASE, JAX_RUNS, PORT_RUNS, SIZES, None,
                         nproc=NPROC)


@pytest.mark.parametrize("name", list(JAX_RUNS))
def test_moe_fsdp_trainer_matches_jax(runs, name):
    """Two updates against the JAX ``Trainer`` on the same mesh, both
    kernel flags: the loss's balance term is one mean over the global
    batch's groups, as the JAX package takes it."""
    ts.assert_matches_jax(runs, name)


@pytest.mark.parametrize("name", [*JAX_RUNS, *PORT_RUNS])
def test_moe_fsdp_trainer_matches_one_process(runs, name):
    """The same rows through one process: losses, eval losses, parameters
    and the optimizer's state within 1e-5 relative; replicated parameters
    bitwise equal across each tensor x expert group."""
    ts.assert_matches_one_process(runs, name)
    assert_ranks_hold_their_part(runs, name, MESHES[name])


@pytest.mark.parametrize("name", list(MESHES))
def test_moe_fsdp_checkpoint_restores_in_one_process(runs, name):
    """Each layout's checkpoint restores bitwise into one process,
    optimizer state included."""
    got = runs["got"][name]
    trainer = ts.one_process_restore(runs, name)
    ts.assert_state_equal(trainer.model.state_dict(), got["params"])
    ts.assert_state_equal(trainer.full_optimizer_state_dict(),
                          got["optimizer"])


def test_moe_checkpoint_restores_across_layouts(runs):
    """The fsdp 2 x tensor 2 run's checkpoint, restored by the tensor 2 x
    expert 2 run, gathers back bitwise: parameters and optimizer state."""
    got = runs["got"]["tensor2_expert2_restores"]
    want = runs["got"]["fsdp2_tensor2"]
    ts.assert_state_equal(got["restored"], want["params"])
    ts.assert_state_equal(got["restored_optimizer"], want["optimizer"])


@pytest.mark.parametrize("name", list(MESHES))
def test_moe_fsdp_held_bytes_are_the_reckoning(runs, name):
    """The parameter bytes each rank holds are ``per_rank_bytes``'
    reckoning, reckoned without a process group."""
    cfg = runs["one"][name]["config"]
    model = MultiModalModel(cfg, device="meta")
    names = trainable_names(model, cfg)
    sizes = dict(zip(DEFAULT_AXIS_NAMES, MESHES[name]))
    want = per_rank_bytes(((n, tuple(p.shape), n in names)
                           for n, p in model.named_parameters()), sizes)
    for held in runs["got"][name]["held"]:
        assert held["params"] == want["params"], held


@pytest.mark.parametrize("shape", [(1, 2, 2, 1, 1, 2), (2, 1, 2, 1, 1, 2),
                                   (2, 2, 1, 1, 1, 2), (1, 1, 2, 2, 1, 1),
                                   (2, 1, 1, 1, 3, 1)])
def test_device_mesh_layout_is_axis_groups(shape):
    """Without a process group: the ``DeviceMesh``'s rank tensor
    (``Mesh.layout``) has, along each axis, the groups of
    ``axis_groups``, and each rank's coordinate in it gives the
    ``Mesh.*_rank`` properties."""
    mesh = Mesh(shape=shape, axis_names=DEFAULT_AXIS_NAMES, group=None,
                cpu_group=None)
    layout = mesh.layout()
    for d, size in enumerate(shape):
        groups = layout.movedim(d, -1).reshape(-1, size).tolist()
        assert sorted(groups) == sorted(axis_groups(shape, [d]))
    for r in range(layout.numel()):
        coord = [int(c) for c in (layout == r).nonzero()[0]]
        m = Mesh(shape=shape, axis_names=DEFAULT_AXIS_NAMES, group=None,
                 cpu_group=None, rank=r)
        assert coord[2:] == [m.tensor_rank, m.seq_rank, m.pipe_rank,
                             m.expert_rank]
        assert coord[0] * shape[1] + coord[1] == m.dp_rank
    assert torch.equal(layout.flatten(), torch.arange(layout.numel()))
