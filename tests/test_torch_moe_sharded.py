"""MoE on a sharded mesh (the ``expert`` axis beside ``fsdp`` and
``tensor``): the ``Trainer`` and ``train()`` over four gloo ranks on the
CPU, and the layouts without a process group.

One torchrun job of 4 ranks runs, one after the other:

* mesh (1, 2, 1, 1, 1, 2): fsdp 2 x expert 2. Each fsdp rank holds its
  rows, rank e of an expert group runs experts [2e, 2e + 2), and FSDP2
  shards every parameter, the bank slices too, over the fsdp ranks;
* mesh (1, 1, 2, 1, 1, 2): tensor 2 x expert 2. The four ranks share the
  rows; rank (t, e) runs columns [t F/2, (t + 1) F/2) of experts
  [2e, 2e + 2), and the tensor x expert group sums the partial combine;

both top-2 with both kernel flags on (their plain versions here), two
fp32 Adam updates from the same converted JAX weights, held against the
JAX ``Trainer`` on the same mesh of the fake CPU devices (its Pallas
kernels in interpret mode): losses within 2e-5 relative, parameters
within rtol 5e-4 / atol 1e-6, the tolerances of
``tests/test_spmd_equivalence.py``. Then, at tensor 2 x expert 2:

* dropout 0.1: the experts' masks drawn whole at (E, G, C, F) and sliced
  on experts and columns, so the run equals one process's; it then
  restores a one-process checkpoint;
* Adafactor on a transformer wide enough (d_model 128, d_ff 256) that the
  banks' second moment is factored over D and F: the row statistic is
  a mean over the columns that the tensor ranks split, summed over them;
* Adafactor at 128 experts of d_model 32 and d_ff 256, factored over the
  experts and F, both cut (expert beside tensor): the row statistic's
  mean over F taken over the tensor group, the column statistic's over
  the experts over the expert group; its checkpoint restores bitwise in
  one process;

and ``train()`` with ``cache_frozen_features`` at fsdp 2 x expert 2, two
epochs of two updates, against one process's ``train()``.

Each is held against the port's one-process ``Trainer`` on the same rows
too (losses, eval losses, parameters and optimizer state within 1e-5
relative); the router and every replicated parameter are bitwise equal on
the ranks of a tensor x expert group, each rank's banks are its slice of
the whole, the bytes a rank holds are ``per_rank_bytes``' reckoning, and
each run's checkpoint restores bitwise into one process.
"""

import os

import numpy as np
import pytest
import torch

import _torch_port as tp
import _torch_split as ts
import klab_multimodalmodel_tpu_torch.config as tcfg
from klab_multimodalmodel_tpu_torch import __main__ as module_main
from klab_multimodalmodel_tpu_torch.checkpoint.io import read_whole
from klab_multimodalmodel_tpu_torch.infer.captioner import Captioner
from klab_multimodalmodel_tpu_torch.models.multimodal import MultiModalModel
from klab_multimodalmodel_tpu_torch.parallel.partitioning import (
    per_rank_bytes)
from klab_multimodalmodel_tpu_torch.train.optim import (optimizer_groups,
                                                        trainable_names)
from klab_multimodalmodel_tpu_torch.utils.mesh import (DEFAULT_AXIS_NAMES,
                                                       axis_groups)

NPROC = 4
EXPERT_FSDP = (1, 2, 1, 1, 1, 2)
EXPERT_TENSOR = (1, 1, 2, 1, 1, 2)
MOE = dict(moe_experts=4, moe_top_k=2, moe_capacity_factor=1.25)
DROP_T5 = "t5-torchport-tiny-dropout-moe-sharded"
WIDE_T5 = "t5-torchport-tiny-wide-moe-sharded"
WIDE = dict(tp.TINY_T5, d_model=128, d_kv=32, d_ff=256)
FF256_T5 = "t5-torchport-tiny-ff256-moe-sharded"  # 128 experts factor dim 0
FF256 = dict(tp.TINY_T5, d_ff=256)
for _name, _kw in ((DROP_T5, dict(tp.TINY_T5, dropout_rate=0.1)),
                   (WIDE_T5, WIDE), (FF256_T5, FF256)):
    tcfg.register_t5_size(_name, tcfg.T5Size(**_kw))
SIZES = dict(t5_sizes={tp.T5_NAMES["v10"][0]: tp.TINY_T5,
                       DROP_T5: dict(tp.TINY_T5, dropout_rate=0.1),
                       WIDE_T5: WIDE, FF256_T5: FF256},
             swin_sizes={tp.SWIN_NAME: tp.TINY_SWIN})
BASE = dict(kernels=True, compute_dtype="float32",
            max_target_length=ts.TGT, batch_size=ts.B, **MOE)
JAX_RUNS = {"fsdp2_expert2": dict(mesh_shape=EXPERT_FSDP),
            "tensor2_expert2": dict(mesh_shape=EXPERT_TENSOR)}
PORT_RUNS = {"dropout": dict(mesh_shape=EXPERT_TENSOR,
                             language_model_name=DROP_T5,
                             transformer_model_name=DROP_T5),
             "adafactor_wide": dict(mesh_shape=EXPERT_TENSOR,
                                    optimizer="adafactor",
                                    transformer_model_name=WIDE_T5),
             "adafactor_128": dict(mesh_shape=EXPERT_TENSOR,
                                   optimizer="adafactor", moe_experts=128,
                                   transformer_model_name=FF256_T5)}
MESHES = {"fsdp2_expert2": EXPERT_FSDP, "tensor2_expert2": EXPERT_TENSOR,
          "dropout": EXPERT_TENSOR, "adafactor_wide": EXPERT_TENSOR,
          "adafactor_128": EXPERT_TENSOR}
BANKS = (".experts_wi", ".experts_wo")


@pytest.fixture(scope="module")
def interpret():
    """The JAX package's Pallas kernels in interpret mode (the CPU)."""
    from klab_multimodalmodel_tpu.ops import set_interpret

    set_interpret(True)
    yield
    set_interpret(False)


@pytest.fixture(scope="module")
def runs(tmp_path_factory, interpret):
    return ts.split_runs(tmp_path_factory.mktemp("moe_sharded"), EXPERT_FSDP,
                         BASE, JAX_RUNS, PORT_RUNS, SIZES,
                         dict(mesh_shape=EXPERT_FSDP), nproc=NPROC)


def rows_groups(mesh: tuple) -> list:
    """The rank groups that share their rows: tensor x seq x pipe x
    expert."""
    return axis_groups(mesh, [2, 3, 4, 5])


def assert_ranks_hold_their_part(runs: dict, name: str, mesh: tuple):
    """The parameters every rank of a tensor x expert group holds alike
    (the router among them) are bitwise equal there; without fsdp each
    rank's banks are its experts' columns of the whole."""
    got = runs["got"][name]
    local, whole = got["local"], got["params"]
    routers = [n for n in whole if n.endswith("mlp.router.weight")]
    assert routers
    for group in rows_groups(mesh):
        first = local[group[0]]
        for r in group[1:]:
            assert set(local[r]) == set(first)
            for n, p in first.items():
                if not n.endswith(BANKS):
                    assert torch.equal(local[r][n], p), (r, n)
    if mesh[1] > 1:
        return
    T, E = mesh[2], mesh[5]
    for r, held in enumerate(local):
        t, e = r // E % T, r % E
        for n in whole:
            if not n.endswith(BANKS):
                continue
            per = whole[n].shape[0] // E  # a rank's experts
            part = whole[n][per * e:per * (e + 1)]
            dim = 2 if n.endswith("wi") else 1
            width = part.shape[dim] // T
            assert torch.equal(held[n], part.narrow(dim, t * width, width)), n


@pytest.mark.parametrize("name", list(JAX_RUNS))
def test_moe_sharded_trainer_matches_jax(runs, name):
    """Two updates against the JAX ``Trainer`` on the same mesh (its XLA
    partitioner splits the experts and their columns), both kernel
    flags."""
    ts.assert_matches_jax(runs, name)


@pytest.mark.parametrize("name", [*JAX_RUNS, *PORT_RUNS])
def test_moe_sharded_trainer_matches_one_process(runs, name):
    """The same rows through one process: losses, eval losses, parameters
    and the optimizer's state within 1e-5 relative (at dropout 0.1 too:
    the same masks); replicated parameters bitwise equal across each
    tensor x expert group; the banks sliced as the layout says."""
    ts.assert_matches_one_process(runs, name)
    assert_ranks_hold_their_part(runs, name, MESHES[name])


def test_adafactor_statistics_of_a_sharded_bank(runs):
    """The wide run's banks (4, 128, 256) and (4, 256, 128) are factored
    over D and F, F the larger: the row statistic (a mean over F, whose
    columns the tensor ranks split) is (4, 128), the column statistic
    (4, 256), gathered whole (and equal to one process's within 1e-5:
    ``test_moe_sharded_trainer_matches_one_process``)."""
    cfg = runs["one"]["adafactor_wide"]["config"]
    model = MultiModalModel(cfg, device="meta")
    names = trainable_names(model, cfg)
    order = [n for g in optimizer_groups(
        cfg, [n for n, _ in model.named_parameters() if n in names])
        for n in g]
    state = runs["got"]["adafactor_wide"]["optimizer"]["state"]
    banks = [i for i, n in enumerate(order) if n.endswith(BANKS)]
    assert len(banks) == 2 * 4
    for i in banks:
        assert state[i]["v_row"].shape == (4, 128), order[i]
        assert state[i]["v_col"].shape == (4, 256), order[i]


def test_adafactor_128_experts_beside_tensor(runs):
    """128 experts at tensor 2 x expert 2: the banks (128, 32, 256) and
    (128, 256, 32) factor the experts' dim and F, both cut; the row
    statistic (128, 32) and the column statistic, without the experts'
    dim, gathered whole (within 1e-5 of one process's:
    ``test_moe_sharded_trainer_matches_one_process``); the run's
    per-shard checkpoint restores bitwise into one process, its optimizer
    state too."""
    cfg = runs["one"]["adafactor_128"]["config"]
    model = MultiModalModel(cfg, device="meta")
    names = trainable_names(model, cfg)
    order = [n for g in optimizer_groups(
        cfg, [n for n, _ in model.named_parameters() if n in names])
        for n in g]
    state = runs["got"]["adafactor_128"]["optimizer"]["state"]
    banks = [i for i, n in enumerate(order) if n.endswith(BANKS)]
    assert len(banks) == 2 * 4
    for i in banks:
        wi = order[i].endswith("experts_wi")
        assert state[i]["v_row"].shape == (128, 32), order[i]
        assert state[i]["v_col"].shape == ((32, 256) if wi else (256, 32))
    ts.assert_checkpoints_cross(runs, "adafactor_128", "dropout")


@pytest.mark.parametrize("name", list(JAX_RUNS))
def test_moe_sharded_checkpoints_restore_in_one_process(runs, name):
    """Each layout's checkpoint restores bitwise into one process,
    optimizer state included; the dropout run (tensor 2 x expert 2)
    restored one process's checkpoint bitwise."""
    ts.assert_checkpoints_cross(runs, name, "dropout")


def test_train_loop_under_fsdp2_expert2(runs):
    """``train()`` at fsdp 2 x expert 2 (each fsdp rank its chunk of the
    rows, the second epoch from the feature cache): one process's
    per-epoch losses, and the last checkpoint restores into one
    process."""
    ts.assert_loop_matches_one_process(runs)


def test_fsdp2_expert2_run_directory_captions_in_one_process(runs, tmp_path,
                                                            capsys):
    """Decode holds every expert and column: the fsdp 2 x expert 2 run's
    directory loads into ``Captioner`` and the ``caption`` command in one
    process, and both caption alike."""
    from PIL import Image

    from klab_multimodalmodel_tpu_torch.data.datasets import (
        load_image_resized)
    from klab_multimodalmodel_tpu_torch.text import ByteTokenizer

    result = runs["loop_cfg"].result_dir
    with open(os.path.join(result, "config.json")) as f:
        config = tcfg.Config.from_json(f.read())
    assert tuple(config.mesh_shape) == EXPERT_FSDP
    path = tmp_path / "img.png"
    Image.new("RGB", (40, 36), color=(30, 140, 90)).save(path)
    state = read_whole(os.path.join(result, "checkpoints", "best"))
    cap = Captioner(config, state, ByteTokenizer(), device="cpu")
    want = cap.caption(load_image_resized(str(path), 32)[None],
                       max_length=6)
    capsys.readouterr()
    assert module_main.main(["caption", str(path), "--result_dir", result,
                             "--max_length", "6", "--device", "cpu"]) == 0
    assert capsys.readouterr().out.splitlines() == [f"{path}\t{want[0]}"]


@pytest.mark.parametrize("name", [*JAX_RUNS, *PORT_RUNS])
def test_held_bytes_are_the_reckoning(runs, name):
    """The parameter bytes each rank holds (FSDP2's shards of the bank
    slices and of the rest) are ``per_rank_bytes``' reckoning, reckoned
    without a process group."""
    cfg = runs["one"][name]["config"]
    model = MultiModalModel(cfg, device="meta")
    names = trainable_names(model, cfg)
    sizes = dict(zip(DEFAULT_AXIS_NAMES, MESHES[name]))
    want = per_rank_bytes(((n, tuple(p.shape), n in names)
                           for n, p in model.named_parameters()), sizes)
    for held in runs["got"][name]["held"]:
        assert held["params"] == want["params"], held


def test_device_mesh_order_is_the_rank_layout(runs):
    """Each rank's ``DeviceMesh`` coordinate is its row-major place over
    the six axes (``expert`` fastest), the order of ``axis_groups`` and
    of ``Mesh.*_rank``."""
    for name, mesh in MESHES.items():
        for held in runs["got"][name]["held"]:
            want = np.unravel_index(held["rank"], mesh)
            assert held["coordinate"] == [int(c) for c in want], name
