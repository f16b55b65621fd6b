"""The port's init as an ordered plan (``models/layers.py`` ``Init``,
``PlanInit``), and the rank pieces that the sharded init and the
per-shard checkpoints share (``parallel/partitioning.py`` ``rank_piece``).
No process group.

* One process's seeded weights are bitwise those the port drew before its
  init became a plan: a digest of every state-dict tensor of three tiny
  geometries (CPU generator), pinned.
* ``init_weights`` runs the plan; drawing each entry into a fresh
  contiguous temporary of the parameter's shape, dtype and device draws
  the same values and leaves the generator in the same state.
* The plan names every state-dict entry once.
* Over every rank of a mesh, the pieces of each parameter fill it: every
  element lies in some rank's piece, the pieces of one replica group
  (the ranks that hold one piece) are equal, and the distinct pieces are
  disjoint; a rank's piece of an optimizer state follows its parameter's.
"""

import hashlib
import math

import pytest
import torch

import _torch_port as tp
from klab_multimodalmodel_tpu_torch.models.multimodal import MultiModalModel
from klab_multimodalmodel_tpu_torch.parallel.partitioning import (
    overlap, piece_view, rank_piece, stack_layers)
from klab_multimodalmodel_tpu_torch.train.optim import state_piece
from klab_multimodalmodel_tpu_torch.utils.mesh import DEFAULT_AXIS_NAMES, Mesh

# sha256 over (name, bytes) of every state-dict tensor, then every buffer,
# of MultiModalModel.init_weights(Generator().manual_seed(3)), as drawn
# before the init became a plan.
DIGESTS = {
    "v10": "177b72f7c16e0e9ca003ea98b1fca6b68f9be6d66793fc9094ff88c5d626d23c",
    "v11": "04d86c620607db8ac389e65f32df6ac8563e04d432cf1c76d04a168dde7013a5",
    "moe": "725cd627004b8077c3bb8bf2137ed5957109b572192c345263c7c0fae5807c70",
}
GEOMETRIES = {"v10": ("v10", {}), "v11": ("v11", {}),
              "moe": ("v10", dict(moe_experts=4))}


def model(name: str, device="cpu") -> MultiModalModel:
    t5, kw = GEOMETRIES[name]
    return MultiModalModel(tp.configs(t5, **kw)[1], device=device)


@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_seeded_weights_are_pinned(name):
    m = model(name)
    m.init_weights(torch.Generator().manual_seed(3))
    h = hashlib.sha256()
    for named in (m.state_dict().items(), m.named_buffers()):
        for n, v in named:
            h.update(n.encode())
            h.update(v.detach().contiguous().numpy().tobytes())
    assert h.hexdigest() == DIGESTS[name]


@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_plan_draws_into_temporaries_as_into_parameters(name):
    m = model(name)
    gen = torch.Generator().manual_seed(5)
    m.init_weights(gen)
    other = torch.Generator().manual_seed(5)
    plan = list(model(name, "meta").init_plan())
    state = m.state_dict()
    assert sorted(n for n, _ in plan) == sorted(state)
    for n, init in plan:
        whole = torch.empty(state[n].shape)
        init(whole, other)
        assert torch.equal(whole, state[n]), n
    assert torch.equal(other.get_state(), gen.get_state())


def meshes(shape):
    shape = tuple(shape) + (1,) * (6 - len(shape))
    return [Mesh(shape=shape, axis_names=DEFAULT_AXIS_NAMES, group=None,
                 cpu_group=None, rank=r) for r in range(math.prod(shape))]


LAYOUTS = {"fsdp2_tensor2": ((1, 2, 2), {}),
           "data2_fsdp3": ((2, 3, 1), {}),
           "fsdp2_pipe2": ((1, 2, 1, 1, 2, 1), dict(pipeline_stages=2)),
           "tensor2_expert2": ((1, 1, 2, 1, 1, 2), dict(moe_experts=4)),
           "fsdp2_expert2": ((1, 2, 1, 1, 1, 2), dict(moe_experts=4)),
           "seq2_tensor2": ((1, 1, 2, 2), {})}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_rank_pieces_tile_every_parameter(layout):
    shape, kw = LAYOUTS[layout]
    cfg = tp.configs("v11", kernels=False, **kw)[1]
    state = MultiModalModel(cfg, device="meta").state_dict()
    layers = stack_layers(state)
    ranks = meshes(shape)
    banks = cfg.moe_experts > 0 and (ranks[0].expert > 1
                                     or ranks[0].tensor > 1)
    for name, v in state.items():
        pieces = [rank_piece(name, tuple(v.shape), m, layers, banks)
                  for m in ranks]
        count = torch.zeros(v.shape, dtype=torch.int32)
        distinct = {p for p in pieces if p is not None}
        for p in distinct:
            piece_view(count, p).add_(1)
        assert int(count.min()) == 1 and int(count.max()) == 1, name
        for a in distinct:
            for b in distinct - {a}:
                assert overlap(a, b) is None or 0 in (
                    n for _, n in a), (name, a, b)
        # Adam's moments take the parameter's pieces; Adafactor's factored
        # row statistic drops the largest factored dim, whole over shards.
        for p in pieces:
            assert state_piece("exp_avg", tuple(v.shape), p, v.dim()) == p
        if v.dim() == 2 and min(v.shape) >= 128:
            whole = rank_piece(name, tuple(v.shape), ranks[-1], layers,
                               banks, whole_over_shards=True)
            row = state_piece("v_row", tuple(v.shape), whole, 1)
            assert len(row) == 1


def test_tensor_and_fsdp_pieces_of_a_projection():
    """A q weight (tensor on dim 0, fsdp on dim 1) at fsdp 2 x tensor 2:
    rank (f, t) holds rows t and columns f of a 2 x 2 grid."""
    name = "transformer.encoder.block.0.layer.0.SelfAttention.q.weight"
    shape = (32, 32)
    got = [rank_piece(name, shape, m, {}, False) for m in meshes((1, 2, 2))]
    assert got == [((0, 16), (0, 16)), ((16, 16), (0, 16)),
                   ((0, 16), (16, 16)), ((16, 16), (16, 16))]
