"""Expert parallelism of the port (an ``expert`` mesh axis above 1) as a
whole: the ``Trainer`` and ``train()`` over two gloo ranks on the CPU,
each holding 2 of the 4 experts of every MoE layer, and the layouts,
bytes and flags without a process group.

One torchrun job of 2 ranks (mesh (1, 1, 1, 1, 1, 2): both ranks hold the
same rows; rank e runs experts [2e, 2e + 2) and the group sums the
partial combine) runs one after the other:

* top-2 with both kernel flags on (their plain versions here), two fp32
  Adam updates from the same converted JAX weights, held against the JAX
  ``Trainer`` on a (1, 1, 1, 1, 1, 2) mesh of the fake CPU devices (its
  Pallas kernels in interpret mode): losses within 2e-5 relative,
  parameters within rtol 5e-4 / atol 1e-6, the tolerances of
  ``tests/test_spmd_equivalence.py``;
* top-1;
* dropout 0.1: the experts' masks drawn whole and sliced, so the run
  equals one process's; it then restores a one-process checkpoint;
* Adafactor on a transformer wide enough (d_model 128) that the expert
  banks' second moment is factored: its statistics of a rank's experts are
  that slice of one process's, and its clipping RMS spans the group;
* Adafactor at 128 experts of d_model 32 and d_ff 256, whose banks
  factor the experts' dim: a column statistic is a mean over all 128
  experts (the mean of the two ranks' means) and the same on both ranks,
  a row statistic the rank's slice; held against the JAX ``Trainer`` as
  the top-2 run is;
* ``train()`` with ``cache_frozen_features``, two epochs of two updates,
  against one process's ``train()``.

Each is held against the port's one-process ``Trainer`` on the same rows
too (losses, eval losses, parameters and optimizer state within 1e-5
relative); the replicated parameters are bitwise equal on the two ranks,
and each rank's banks are its slice of the whole.
"""

import os

import numpy as np
import pytest
import torch

import jax

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
    per_rank_bytes, spec_for_path)
from klab_multimodalmodel_tpu_torch.text import ByteTokenizer
from klab_multimodalmodel_tpu_torch.train.optim import trainable_names

EXPERT = (1, 1, 1, 1, 1, 2)
MOE = dict(moe_experts=4, moe_top_k=2, moe_capacity_factor=1.25)
DROP_T5 = "t5-torchport-tiny-dropout-ep"
WIDE_T5 = "t5-torchport-tiny-wide-ep"
WIDE = dict(tp.TINY_T5, d_model=128, d_kv=32, d_ff=256)
FF256_T5 = "t5-torchport-tiny-ff256-ep"  # 128 experts factor dim 0
FF256 = dict(tp.TINY_T5, d_ff=256)
for _name, _kw in ((DROP_T5, dict(tp.TINY_T5, dropout_rate=0.1)),
                   (WIDE_T5, WIDE)):
    tcfg.register_t5_size(_name, tcfg.T5Size(**_kw))
tcfg.register_t5_size(FF256_T5, tcfg.T5Size(**FF256))
jcfg.register_t5_size(FF256_T5, jcfg.T5Size(**FF256))
SIZES = dict(t5_sizes={tp.T5_NAMES["v10"][0]: tp.TINY_T5,
                       DROP_T5: dict(tp.TINY_T5, dropout_rate=0.1),
                       WIDE_T5: WIDE, FF256_T5: FF256},
             swin_sizes={tp.SWIN_NAME: tp.TINY_SWIN})
BASE = dict(kernels=True, compute_dtype="float32",
            max_target_length=ts.TGT, batch_size=ts.B, **MOE)
JAX_RUNS = {"top2_kernels": dict(),
            "adafactor_128": dict(optimizer="adafactor", moe_experts=128,
                                  transformer_model_name=FF256_T5)}
PORT_RUNS = {"top1": dict(moe_top_k=1),
             "dropout": dict(language_model_name=DROP_T5,
                             transformer_model_name=DROP_T5),
             "adafactor_wide": dict(optimizer="adafactor",
                                    transformer_model_name=WIDE_T5)}


@pytest.fixture(scope="module")
def interpret():
    """The JAX package's Pallas kernels in interpret mode (the CPU)."""
    from klab_multimodalmodel_tpu.ops import set_interpret

    set_interpret(True)
    yield
    set_interpret(False)


@pytest.fixture(scope="module")
def runs(tmp_path_factory, interpret):
    return ts.split_runs(tmp_path_factory.mktemp("expert"), EXPERT, BASE,
                         JAX_RUNS, PORT_RUNS, SIZES, dict())


def _banks(names) -> list:
    return [n for n in names if n.endswith((".experts_wi", ".experts_wo"))]


def test_expert2_trainer_matches_jax(runs):
    """Two updates at expert 2 against the JAX ``Trainer`` on the same
    mesh (its XLA partitioner splits the experts), both kernel flags."""
    ts.assert_matches_jax(runs, "top2_kernels")


@pytest.mark.parametrize("name", [*JAX_RUNS, *PORT_RUNS])
def test_expert2_trainer_matches_one_process(runs, name):
    """The same rows through one process: losses, eval losses, parameters
    and the optimizer's state within 1e-5 relative (at dropout 0.1 too:
    the same masks); the replicated parameters bitwise equal on both
    ranks; each rank holds its half of the experts of every bank, which
    gather into the whole."""
    ts.assert_matches_one_process(runs, name)
    got = runs["got"][name]
    r0, r1 = got["local"]
    whole = got["params"]
    assert set(r0) == set(r1) == set(whole)
    banks = _banks(whole)
    assert len(banks) == 2 * 4  # 2 + 2 blocks, wi and wo
    for n in whole:
        if n in banks:
            per = whole[n].shape[0] // 2  # a rank's experts
            for r, local in enumerate((r0, r1)):
                assert torch.equal(local[n],
                                   whole[n][per * r:per * (r + 1)]), n
        else:
            assert torch.equal(r0[n], r1[n]), n


def test_adafactor_statistics_of_an_expert_slice(runs):
    """The wide run's banks (4, 128, 256) are factored: their
    second-moment rows and columns are per expert, gathered from each
    rank's slice (and within 1e-5 of one process's:
    ``test_expert2_trainer_matches_one_process``)."""
    from klab_multimodalmodel_tpu_torch.train.optim import optimizer_groups

    cfg = runs["one"]["adafactor_wide"]["config"]
    model = MultiModalModel(cfg, device="meta")
    names = trainable_names(model, cfg)
    order = [n for g in optimizer_groups(
        cfg, [n for n, _ in model.named_parameters() if n in names])
        for n in g]
    state = runs["got"]["adafactor_wide"]["optimizer"]["state"]
    banks = [i for i, n in enumerate(order) if _banks([n])]
    assert len(banks) == 2 * 4
    for i in banks:
        assert state[i]["v_row"].shape[0] == 4, order[i]
        assert state[i]["v_col"].shape[0] == 4, order[i]


def test_adafactor_factoring_the_experts_dim_matches_jax(runs):
    """128 experts (banks (128, 32, 256) and (128, 256, 32)) factor the
    experts' dim: two Adafactor updates at expert 2 against the JAX
    ``Trainer`` on the same mesh; the column statistic drops the experts'
    dim (whole on every rank), the row statistic keeps it (gathered from
    the ranks' slices), both within 1e-5 of one process's
    (``test_expert2_trainer_matches_one_process``)."""
    from klab_multimodalmodel_tpu_torch.train.optim import optimizer_groups

    ts.assert_matches_jax(runs, "adafactor_128")
    cfg = runs["one"]["adafactor_128"]["config"]
    model = MultiModalModel(cfg, device="meta")
    names = trainable_names(model, cfg)
    order = [n for g in optimizer_groups(
        cfg, [n for n, _ in model.named_parameters() if n in names])
        for n in g]
    state = runs["got"]["adafactor_128"]["optimizer"]["state"]
    banks = [i for i, n in enumerate(order) if _banks([n])]
    assert len(banks) == 2 * 4
    for i in banks:
        wi = order[i].endswith("experts_wi")
        assert state[i]["v_row"].shape == (128, 32), order[i]
        assert state[i]["v_col"].shape == ((32, 256) if wi else (256, 32))


def test_expert2_checkpoints_cross_layouts(runs):
    """The top-2 run's checkpoint (expert 2) restores bitwise into one
    process, optimizer state included; the dropout run (expert 2)
    restored one process's checkpoint bitwise."""
    ts.assert_checkpoints_cross(runs, "top2_kernels", "dropout")


def test_train_loop_under_expert2(runs):
    """``train()`` at expert 2 (both ranks read the same rows, the second
    epoch from the feature cache): one process's per-epoch losses, and the
    last checkpoint restores into one process."""
    ts.assert_loop_matches_one_process(runs)


def test_expert2_run_directory_captions_in_one_process(runs, tmp_path,
                                                       capsys):
    """Decode holds every expert: the expert-2 run's directory (its config
    names mesh (1, 1, 1, 1, 1, 2)) loads into ``Captioner`` and the
    ``caption`` command in one process, and both caption alike."""
    from PIL import Image

    from klab_multimodalmodel_tpu_torch.data.datasets import (
        load_image_resized)

    result = runs["loop_cfg"].result_dir
    with open(os.path.join(result, "config.json")) as f:
        config = tcfg.Config.from_json(f.read())
    assert config.mesh_shape[5] == 2
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


def test_per_rank_bytes_counts_the_experts(runs):
    """``per_rank_bytes`` at expert 2 reckons a rank's parameter bytes as
    the rank holds them (the top-2 run's ``local`` dumps)."""
    cfg = runs["one"]["top2_kernels"]["config"]
    model = MultiModalModel(cfg, device="meta")
    names = trainable_names(model, cfg)
    want = per_rank_bytes(((n, tuple(p.shape), n in names)
                           for n, p in model.named_parameters()),
                          {"expert": 2})
    whole = per_rank_bytes(((n, tuple(p.shape), n in names)
                            for n, p in model.named_parameters()), {})
    for local in runs["got"]["top2_kernels"]["local"]:
        assert want["params"] == 4 * sum(p.numel() for p in local.values())
    bank = sum(p.numel() for n, p in model.named_parameters()
               if n in _banks([n]))
    assert whole["params"] - want["params"] == 4 * bank // 2


def test_expert_rule_matches_jax_make_param_specs(runs):
    """The JAX ``make_param_specs`` on an MoE tree puts ``expert`` on the
    banks' experts dim; ``spec_for_path`` puts it on the converted banks'
    dim 0, and that dim is the JAX one: a tree whose expert leaves hold
    their expert's index along it converts to banks that hold it along
    dim 0 (and no other parameter is split over experts)."""
    from klab_multimodalmodel_tpu.parallel.partitioning import (
        make_param_specs)

    abstract, tc = runs["jax_params"], runs["tc"]
    specs = make_param_specs(abstract)

    def fill(spec, leaf):
        spec = tuple(spec)
        if "expert" not in spec:
            return np.full(leaf.shape, -1.0, np.float32)
        # A scanned stack's leaf leads with its layer axis.
        d = spec.index("expert")
        idx = np.arange(leaf.shape[d], dtype=np.float32)
        shape = [1] * len(leaf.shape)
        shape[d] = -1
        return np.broadcast_to(idx.reshape(shape), leaf.shape).copy()

    tree = jax.tree.map(fill, specs, abstract,
                        is_leaf=lambda x: isinstance(
                            x, jax.sharding.PartitionSpec))
    converted = convert_jax_params(tree, tc)
    experts = 0
    for name, t in converted.items():
        spec = spec_for_path(name, t.dim())
        if "expert" in spec:
            experts += 1
            assert spec[0] == "expert", name
            want = torch.arange(4.0).reshape((-1,) + (1,) * (t.dim() - 1))
            assert torch.equal(t, want.expand(t.shape)), name
        else:
            assert bool((t == -1).all()), name
    assert experts == 2 * 4


@pytest.mark.parametrize("overrides,error", [
    (dict(moe_experts=4, mesh_shape=(1, 1, 1, 1, 1, 2)), None),
    (dict(moe_experts=4, mesh_shape=(2, 1, 1, 1, 1, 4)), None),
    (dict(moe_experts=4, mesh_shape=(1, 1, 1, 1, 1, -1)), None),
    (dict(moe_experts=6, mesh_shape=(1, 1, 1, 1, 1, 4)), ValueError),
    (dict(mesh_shape=(1, 1, 1, 1, 1, 2)), ValueError),
    (dict(moe_experts=4, dcn_mesh_shape=(1, 1, 1, 1, 1, 3)), ValueError),
    (dict(moe_experts=4, mesh_shape=(1, 1, 1, 1, 1, 2),
          pipeline_stages=2, use_pallas_t5_attention=False), ValueError),
    (dict(moe_experts=4, mesh_shape=(1, 1, 2, 1, 1, 2)), None),
    (dict(moe_experts=4, mesh_shape=(1, 1, 1, 2, 1, 2)), None),
])
def test_expert_flags_take_or_refuse_as_jax(overrides, error):
    """The expert axis builds where the JAX ``Config`` builds it (beside
    tensor and seq too) and raises its ValueError where it refuses."""
    import klab_multimodalmodel_tpu.config as jcfg

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
    assert t.moe_experts == j.moe_experts
