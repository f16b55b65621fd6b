"""The port's mesh and process-group set-up (``utils/mesh.py``) against the
JAX package's ``utils/mesh.py``: the pure shape functions on the same
inputs, errors included; the layouts that build, and the JAX package's
refusals of the pipe axis beside seq or expert (in ``make_mesh``,
``Config`` and the command line); the environment of
torchrun and of the JAX package's ``KLAB_*`` variables; the rank's device."""

import os

import pytest
import torch

import klab_multimodalmodel_tpu.config as jcfg
from klab_multimodalmodel_tpu.utils import mesh as jmesh
from klab_multimodalmodel_tpu_torch.config import Config, parse_arguments
from klab_multimodalmodel_tpu_torch.utils import mesh as tmesh

PAD_CASES = [((4, 1, 1), 6), ((-1, 2, 1, 1), 6), ((2,), 3),
             ((1, 1, 1, 1, 1, 1), 6), ((1, 1, 1, 1, 1, 1, 1), 6)]
RESOLVE_CASES = [((-1, 1, 1, 1, 1, 1), 8), ((2, -1, 1), 8), ((4, 2, 1), 8),
                 ((-1, -1, 1), 8), ((3, -1, 1), 8), ((4, 1, 1), 8),
                 ((-1, 1, 1), 1)]


def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except ValueError as e:
        return ("error", str(e))


@pytest.mark.parametrize("shape,n", PAD_CASES)
def test_pad_mesh_shape_matches_jax(shape, n):
    assert (_outcome(tmesh.pad_mesh_shape, shape, n)
            == _outcome(jmesh.pad_mesh_shape, shape, n))


@pytest.mark.parametrize("shape,n", RESOLVE_CASES)
def test_resolve_mesh_shape_matches_jax(shape, n):
    assert (_outcome(tmesh.resolve_mesh_shape, shape, n)
            == _outcome(jmesh.resolve_mesh_shape, shape, n))


PIPE = dict(pipeline_stages=2, use_pallas_t5_attention=False)
EXPERT = dict(moe_experts=2)


@pytest.mark.parametrize("shape,flags,item", [
    ((1, 2, 1, 1, 2), PIPE, None), ((1, 1, 2, 1, 2), PIPE, None),
    ((1, 2, 2, 1, 2), PIPE, None), ((1, 1, 1, 1, 2, 2), PIPE,
                                    "requires --moe_experts"),
    ((1, 1, 1, 2, 2), PIPE, "seq mesh axis"), ((1, 1, 1, 1, 2), PIPE, None),
    ((1, 1, 1, 1, 1, 2), EXPERT, None),
    ((1, -1, 1, 1, 1, 2), EXPERT, None), ((1, 2, 2, 1, 1, 2), EXPERT, None),
    ((1, 1, 1, 2, 1, 2), EXPERT, None),
    ((1, 2, 1, 2), {}, None), ((1, 1, 2, 2), {}, None),
    ((1, 2, 2, 2), {}, None)])
def test_non_data_axes_are_refused(shape, flags, item):
    """The pipe axis beside seq or expert (as ``mesh_shape`` or
    ``dcn_mesh_shape``) is refused by ``make_mesh`` with the JAX
    ``Config``'s words for stages beside a seq axis or MoE, and by
    ``Config`` and the command line, with the flags that the axis needs,
    with the JAX package's ValueError (stages with seq, an expert axis
    without experts). Alone, and the pipe, expert and seq axes beside
    fsdp and tensor, and the expert axis beside seq (the -1 wildcard too),
    each builds as the JAX ``Config`` builds it, and ``make_mesh`` asks
    only for the world to match."""
    pipe_beside = [a for a, i in (("seq", 3), ("expert", 5))
                   if shape[4:5] == (2,) and len(shape) > i
                   and shape[i] != 1]
    for kw in (dict(mesh_shape=shape), dict(mesh_shape=(-1, 1, 1),
                                            dcn_mesh_shape=shape)):
        with pytest.raises(ValueError) as err:
            tmesh.make_mesh(**kw)
        if pipe_beside:
            assert str(err.value) == tmesh.PIPE_BESIDE[pipe_beside[0]]
            with pytest.raises(ValueError) as want:
                jcfg.Config(mesh_shape=shape, pipeline_stages=2,
                            use_pallas_t5_attention=False,
                            moe_experts=2 * (pipe_beside[0] == "expert"))
            assert str(err.value) == str(want.value)
        else:
            assert any(w in str(err.value) for w in (
                "device count", "divisible", "does not divide")), err.value
    argv = [f"--{k}" if v is True else f"--{k} {v}" for k, v in flags.items()
            if v is not False]
    for field in ("mesh_shape", "dcn_mesh_shape"):
        cli = " ".join(argv + [f"--{field}", *map(str, shape)]).split()
        if item is None:
            want = jmesh.pad_mesh_shape(shape)
            assert getattr(Config(**{field: shape}, **flags), field) == want
            assert getattr(parse_arguments(cli), field) == want
            continue
        with pytest.raises(ValueError, match=item):
            Config(**{field: shape}, **flags)
        with pytest.raises(ValueError, match=item):
            parse_arguments(cli)


def test_data_axis_resolves_over_the_world():
    """One process: data -1 (or 1, or 1 x dcn 1) is 1; a data factor that
    is not the world raises; 3-axis shapes pad as the JAX config pads."""
    m = tmesh.make_mesh((-1, 1, 1))
    assert (m.shape, m.data, m.distributed) == ((1,) * 6, 1, False)
    assert tmesh.make_mesh((1, 1, 1, 1, 1, 1), dcn_mesh_shape=(1, 1, 1)
                           ).shape == (1,) * 6
    with pytest.raises(ValueError, match="device count"):
        tmesh.make_mesh((2, 1, 1))
    with pytest.raises(ValueError, match="divisible"):
        tmesh.make_mesh((-1, 1, 1), dcn_mesh_shape=(2, 1, 1))
    c = Config(mesh_shape=(-1, 1, 1), dcn_mesh_shape=(2, 1, 1))
    assert c.mesh_shape == (-1, 1, 1, 1, 1, 1)
    assert c.dcn_mesh_shape == (2, 1, 1, 1, 1, 1)
    assert Config.from_json(c.to_json()).dcn_mesh_shape == c.dcn_mesh_shape
    args = parse_arguments(["--mesh_shape", "2", "1", "1",
                            "--dcn_mesh_shape", "2", "1", "1"])
    assert args.mesh_shape == (2, 1, 1, 1, 1, 1)
    assert args.preempt_sync_steps == 10


TORCHRUN = dict(RANK="1", WORLD_SIZE="4", LOCAL_RANK="1",
                MASTER_ADDR="127.0.0.1", MASTER_PORT="29400")
KLAB = dict(KLAB_MULTIHOST="1", KLAB_COORDINATOR="localhost:1234",
            KLAB_NUM_PROCESSES="2", KLAB_PROCESS_ID="1")


def test_environment_parsing():
    assert tmesh.distributed_env({}) is None
    assert tmesh.distributed_env(dict(KLAB_MULTIHOST="0")) is None
    assert tmesh.distributed_env(TORCHRUN) == tmesh.DistEnv(
        rank=1, world_size=4, local_rank=1, init_method="env://")
    assert tmesh.distributed_env(KLAB) == tmesh.DistEnv(
        rank=1, world_size=2, local_rank=1,
        init_method="tcp://localhost:1234")
    assert tmesh.distributed_env(dict(KLAB, LOCAL_RANK="0")).local_rank == 0
    # torchrun's variables win over the KLAB_* ones.
    assert tmesh.distributed_env(dict(KLAB, **TORCHRUN)).world_size == 4
    with pytest.raises(ValueError, match="MASTER_PORT"):
        tmesh.distributed_env(dict(RANK="0", WORLD_SIZE="2",
                                   MASTER_ADDR="h"))
    with pytest.raises(ValueError, match="KLAB_PROCESS_ID"):
        tmesh.distributed_env(dict(KLAB, KLAB_PROCESS_ID=""))


def test_rank_device_and_backend():
    """A rank whose LOCAL_RANK has no card raises; an explicit device is
    taken as given; a one-process job or no job initializes nothing; only
    'gloo' is a host backend."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="LOCAL_RANK 1 has no card"):
            tmesh.rank_device(None, TORCHRUN)
        with pytest.raises(RuntimeError, match="has no card"):
            tmesh.maybe_init_distributed(None, environ=TORCHRUN)
    assert tmesh.rank_device("cpu", TORCHRUN) == torch.device("cpu")
    with pytest.raises(ValueError, match="only host backend"):
        tmesh.maybe_init_distributed(
            "cpu", environ=dict(TORCHRUN, KLAB_CPU_COLLECTIVES="mpi"))
    assert not tmesh.maybe_init_distributed("cpu", environ={})
    assert not tmesh.maybe_init_distributed(
        "cpu", environ=dict(TORCHRUN, WORLD_SIZE="1", RANK="0"))
    assert not torch.distributed.is_initialized()


def test_single_process_commands_refuse_a_job(monkeypatch):
    from klab_multimodalmodel_tpu_torch import cli

    for key, value in TORCHRUN.items():
        monkeypatch.setenv(key, value)
    with pytest.raises(RuntimeError, match="eval runs in one process"):
        cli.eval_main(["--result_dir", "nowhere"])
    with pytest.raises(RuntimeError, match="serve runs in one process"):
        cli.serve_main(["--result_dir", "nowhere"])
    assert os.environ["WORLD_SIZE"] == "4"


@pytest.mark.parametrize("shape", [(2, 1, 1, 1, 1, 2), (2, 1, 1, 1, 2, 1),
                                   (1, 2, 2, 1, 1, 1), (2, 1, 1, 2, 1, 1),
                                   (3, 1, 1, 1, 2, 1)])
def test_rank_layout_is_row_major_over_six_axes(shape):
    """Each rank's place on every axis is its row-major coordinate in the
    JAX order (data, fsdp, tensor, seq, pipe, expert); its rows are its
    data x fsdp index. The groups along an axis (``axis_groups``) hold
    the ranks that differ on it alone, so the data group that DDP spans
    under the pipe or expert split (data, fsdp and seq) never mixes two
    stages or two expert slices."""
    import math

    import numpy as np

    names = tmesh.DEFAULT_AXIS_NAMES
    for rank in range(math.prod(shape)):
        m = tmesh.Mesh(shape=shape, axis_names=names, group=None,
                       cpu_group=None, rank=rank)
        d, f, t, s, p, e = np.unravel_index(rank, shape)
        assert (m.dp_rank, m.tensor_rank, m.seq_rank, m.pipe_rank,
                m.expert_rank) == (d * shape[1] + f, t, s, p, e)
        assert m.dp_size == shape[0] * shape[1]
    coords = [np.unravel_index(r, shape) for r in range(math.prod(shape))]
    for axes in ([4], [5], [3], [0, 1, 3]):
        groups = tmesh.axis_groups(shape, axes)
        assert sorted(r for g in groups for r in g) == list(
            range(math.prod(shape)))
        for g in groups:
            assert len(g) == math.prod(shape[a] for a in axes)
            for r in g:
                assert all(coords[r][i] == coords[g[0]][i]
                           for i in range(6) if i not in axes)
