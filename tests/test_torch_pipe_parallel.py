"""Pipeline parallelism of the port (a ``pipe`` mesh axis above 1) as a
whole: the ``Trainer`` and ``train()`` over two gloo ranks on the CPU,
each holding one GPipe stage of the transformer's two stacks, and the
layouts, bytes and flags without a process group.

One torchrun job of 2 ranks (mesh (1, 1, 1, 1, 2, 1), ``pipeline_stages``
2: both ranks hold the same rows; rank s runs the second half of each
stack's blocks if s is 1, the first if 0, and the microbatches shift from
rank 0 to rank 1 and their cotangents back) runs one after the other:

* 2 microbatches at the tiny 2 + 2-block transformer (a block a stage),
  the Swin kernel on (its plain version here) and the T5 kernel off (the
  JAX package refuses it with stages), two fp32 Adam updates from the
  same converted JAX weights, held against the JAX
  ``Trainer`` on a (1, 1, 1, 1, 2, 1) mesh of the fake CPU devices:
  losses within 2e-5 relative, parameters within rtol 5e-4 / atol 1e-6,
  the tolerances of ``tests/test_spmd_equivalence.py``;
* at 4 + 4 blocks (two a stage): 4 microbatches;
* ``remat='full'``, whose recompute runs inside the written-out backward;
* dropout 0.1: each (stage, microbatch) draws from a generator keyed on
  the pair, so the run equals one process's; it then restores a
  one-process checkpoint;
* ``train()`` with ``cache_frozen_features``, two epochs of two updates,
  against one process's ``train()`` (4 + 4 blocks).

Each is held against the port's one-process ``Trainer`` (which runs both
stages in tick order) on the same rows too: losses, eval losses,
parameters and optimizer state within 1e-5 relative; the replicated
parameters are bitwise equal on the two ranks, and each rank holds its
stage's blocks.
"""

import os

import numpy as np
import pytest
import torch

import _torch_port as tp
import _torch_split as ts
import klab_multimodalmodel_tpu.config as jcfg
import klab_multimodalmodel_tpu_torch.config as tcfg
from klab_multimodalmodel_tpu_torch import __main__ as module_main
from klab_multimodalmodel_tpu_torch.checkpoint.from_jax import (
    convert_jax_params)
from klab_multimodalmodel_tpu_torch.checkpoint.io import read_whole
from klab_multimodalmodel_tpu_torch.infer.captioner import Captioner
from klab_multimodalmodel_tpu_torch.models.multimodal import MultiModalModel
from klab_multimodalmodel_tpu_torch.parallel.partitioning import (
    per_rank_bytes, stack_layers, stage_for_path)
from klab_multimodalmodel_tpu_torch.text import ByteTokenizer
from klab_multimodalmodel_tpu_torch.train.optim import trainable_names

PIPE = (1, 1, 1, 1, 2, 1)
T5_4 = "t5-torchport-tiny-4layer-pp"
DROP_4 = "t5-torchport-tiny-4layer-dropout-pp"
KW4 = dict(tp.TINY_T5, num_layers=4, num_decoder_layers=4)
for _name, _kw in ((T5_4, KW4), (DROP_4, dict(KW4, dropout_rate=0.1))):
    jcfg.register_t5_size(_name, jcfg.T5Size(**_kw))
    tcfg.register_t5_size(_name, tcfg.T5Size(**_kw))
SIZES = dict(t5_sizes={tp.T5_NAMES["v10"][0]: tp.TINY_T5, T5_4: KW4,
                       DROP_4: dict(KW4, dropout_rate=0.1)},
             swin_sizes={tp.SWIN_NAME: tp.TINY_SWIN})
BASE = dict(kernels=True, use_pallas_t5_attention=False,
            compute_dtype="float32", max_target_length=ts.TGT,
            batch_size=ts.B, pipeline_stages=2)
# Against JAX at the tiny 2 + 2-block transformer (a block a stage); the
# port's own cases at 4 + 4 blocks (two a stage).
JAX_RUNS = {"m2": dict(pipeline_microbatches=2)}
PORT_RUNS = {"m4": dict(pipeline_microbatches=4,
                        transformer_model_name=T5_4),
             "remat_full": dict(remat="full", transformer_model_name=T5_4),
             "dropout": dict(transformer_model_name=DROP_4)}


@pytest.fixture(scope="module")
def interpret():
    """The JAX package's Pallas kernels in interpret mode (the CPU)."""
    from klab_multimodalmodel_tpu.ops import set_interpret

    set_interpret(True)
    yield
    set_interpret(False)


@pytest.fixture(scope="module")
def runs(tmp_path_factory, interpret):
    return ts.split_runs(tmp_path_factory.mktemp("pipe"), PIPE, BASE,
                         JAX_RUNS, PORT_RUNS, SIZES,
                         dict(transformer_model_name=T5_4))


def _stage(name: str, layers: dict):
    return stage_for_path(name, layers, 2)


def test_pipe2_trainer_matches_jax(runs):
    """Two updates at pipe 2 against the JAX ``Trainer`` on the same mesh
    (its stages over the mesh's pipe axis)."""
    ts.assert_matches_jax(runs, "m2")


@pytest.mark.parametrize("name", [*JAX_RUNS, *PORT_RUNS])
def test_pipe2_trainer_matches_one_process(runs, name):
    """The same rows through one process: losses, eval losses, parameters
    and the optimizer's state within 1e-5 relative (at dropout 0.1 too);
    the replicated parameters bitwise equal on both ranks; rank s holds
    exactly stage s's blocks (and every block-0 relative-position table);
    each microbatch of each stack shifted once a step."""
    ts.assert_matches_one_process(runs, name)
    got = runs["got"][name]
    whole = got["params"]
    layers = stack_layers(whole)
    L = runs["one"][name]["config"].transformer_t5.num_layers
    assert layers == {"encoder": L, "decoder": L}
    r0, r1 = got["local"]
    for r, local in enumerate((r0, r1)):
        want = {n for n in whole if _stage(n, layers) in (None, r)}
        assert set(local) == want, r
        for n, p in local.items():
            assert torch.equal(p, whole[n]), n
    for n in set(r0) & set(r1):
        assert _stage(n, layers) is None
        assert torch.equal(r0[n], r1[n]), n
    M = runs["one"][name]["config"].pipeline_microbatches or 2
    assert got["shifts"] == 2 * 2 * M  # 2 steps x 2 stacks, rank 0's sends


def test_pipe2_checkpoints_cross_layouts(runs):
    """The 2-microbatch run's checkpoint (pipe 2) restores bitwise into one
    process, optimizer state included; the dropout run (pipe 2) restored
    one process's checkpoint bitwise."""
    ts.assert_checkpoints_cross(runs, "m2", "dropout")


def test_train_loop_under_pipe2(runs):
    """``train()`` at pipe 2 (both ranks read the same rows, the second
    epoch from the feature cache): one process's per-epoch losses, and the
    last checkpoint restores into one process."""
    ts.assert_loop_matches_one_process(runs)


def test_pipe2_run_directory_captions_in_one_process(runs, tmp_path,
                                                       capsys):
    """Decode runs unpipelined: the pipe-2 run's directory (its config
    names mesh (1, 1, 1, 1, 2, 1)) loads into ``Captioner`` and the
    ``caption`` command in one process, and both caption alike."""
    from PIL import Image

    from klab_multimodalmodel_tpu_torch.data.datasets import (
        load_image_resized)

    result = runs["loop_cfg"].result_dir
    with open(os.path.join(result, "config.json")) as f:
        config = tcfg.Config.from_json(f.read())
    assert config.mesh_shape[4] == 2
    path = tmp_path / "img.png"
    Image.new("RGB", (40, 36), color=(120, 40, 200)).save(path)
    state = read_whole(os.path.join(result, "checkpoints", "best"))
    cap = Captioner(config, state, ByteTokenizer(), device="cpu")
    want = cap.caption(load_image_resized(str(path), 32)[None],
                       max_length=6)
    capsys.readouterr()
    assert module_main.main(["caption", str(path), "--result_dir", result,
                             "--max_length", "6", "--device", "cpu"]) == 0
    assert capsys.readouterr().out.splitlines() == [f"{path}\t{want[0]}"]


def test_per_rank_bytes_counts_the_stages(runs):
    """``per_rank_bytes`` at pipe 2 reckons each rank's parameter bytes as
    the rank holds them (the 2-microbatch run's ``local`` dumps)."""
    cfg = runs["one"]["m2"]["config"]
    model = MultiModalModel(cfg, device="meta")
    names = trainable_names(model, cfg)
    shapes = [(n, tuple(p.shape), n in names)
              for n, p in model.named_parameters()]
    for r, local in enumerate(runs["got"]["m2"]["local"]):
        want = per_rank_bytes(shapes, {"pipe": 2}, pipe_rank=r)
        assert want["params"] == 4 * sum(p.numel() for p in local.values())


def test_pipe_rule_matches_jax_make_param_specs(runs):
    """The JAX ``make_param_specs`` on a pipelined tree puts ``pipe`` on the
    stacks' leading stage axis and leaves the relative-position tables
    replicated; ``stage_for_path`` gives each converted block's stage: a
    tree whose pipelined leaves hold their stage's index along that axis
    converts to blocks that hold their ``stage_for_path``, and to -1 where
    it gives None."""
    from klab_multimodalmodel_tpu.parallel.partitioning import (
        make_param_specs)

    abstract, tc = runs["jax_params"], runs["tc"]
    specs = make_param_specs(abstract)

    def fill(spec, leaf):
        if len(spec) and spec[0] == "pipe":
            idx = np.arange(leaf.shape[0], dtype=np.float32)
            return np.broadcast_to(idx.reshape((-1,) + (1,) * (
                len(leaf.shape) - 1)), leaf.shape).copy()
        return np.full(leaf.shape, -1.0, np.float32)

    import jax

    tree = jax.tree.map(fill, specs, abstract,
                        is_leaf=lambda x: isinstance(
                            x, jax.sharding.PartitionSpec))
    converted = convert_jax_params(tree, tc)
    layers = stack_layers(converted)
    staged = 0
    for name, t in converted.items():
        s = _stage(name, layers)
        staged += s is not None
        assert bool((t == (-1 if s is None else s)).all()), (name, s)
    assert staged > 0


@pytest.mark.parametrize("overrides,error", [
    (dict(pipeline_stages=2, mesh_shape=(1, 1, 1, 1, 2, 1)), None),
    (dict(pipeline_stages=2, pipeline_microbatches=4,
          mesh_shape=(2, 1, 1, 1, 2, 1)), None),
    (dict(pipeline_stages=4, mesh_shape=(1, 1, 1, 1, -1, 1)), None),
    (dict(pipeline_stages=2, mesh_shape=(1, 1, 1, 1, 1, 1)), None),
    (dict(pipeline_stages=2, mesh_shape=(1, 1, 1, 1, 4, 1)), ValueError),
    (dict(mesh_shape=(1, 1, 1, 1, 2, 1)), ValueError),
    (dict(pipeline_stages=2, mesh_shape=(1, 1, 1, 1, 2, 1),
          use_pallas_t5_attention=True), ValueError),
    (dict(pipeline_stages=2, mesh_shape=(1, 1, 1, 2, 2, 1)), ValueError),
    (dict(pipeline_stages=2, mesh_shape=(1, 1, 1, 1, 2, 1),
          seq_attention="ring"), ValueError),
    (dict(pipeline_stages=2, dcn_mesh_shape=(1, 1, 1, 1, 3, 1)),
     ValueError),
    (dict(pipeline_stages=2, mesh_shape=(1, 2, 1, 1, 2, 1)), None),
    (dict(pipeline_stages=2, mesh_shape=(1, 1, 2, 1, 2, 1)), None),
    (dict(pipeline_stages=2, mesh_shape=(1, 2, 2, 1, 1, 1)), None),
    (dict(pipeline_stages=2, mesh_shape=(2, 2, 2, 1, 2, 1)), None),
])
def test_pipe_flags_take_or_refuse_as_jax(overrides, error):
    """The pipe axis builds where the JAX ``Config`` builds it (equal to
    the stages, 1, or the -1 wildcard; beside fsdp and tensor too, and
    stages at pipe 1 on an fsdp x tensor mesh) and raises its ValueError
    where it refuses (another size, no stages, the T5 kernel, seq, the
    ring)."""
    if error is ValueError:
        with pytest.raises(ValueError) as want:
            jcfg.Config(**overrides)
        with pytest.raises(ValueError) as got:
            tcfg.Config(**overrides)
        assert str(got.value) == str(want.value)
        return
    j = jcfg.Config(**overrides)
    t = tcfg.Config(**overrides)
    assert tuple(t.mesh_shape) == tuple(j.mesh_shape)
    assert t.pipeline_stages == j.pipeline_stages
