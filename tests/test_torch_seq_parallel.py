"""Sequence parallelism of the port (a ``seq`` mesh axis above 1) as a
whole: the ``Trainer`` and ``train()`` over two gloo ranks on the CPU, the
plain kernels' ``q_offset``, and the config and command line.

One torchrun job of 2 ranks (mesh (1, 1, 1, 2): both ranks hold the same
rows, each its half of every T5 stack's positions) runs one after the
other:

* the all-gather path with both kernel flags on (the plain kernel
  versions with ``q_offset``) and the ring (``--seq_attention ring``, the
  T5 kernel off), two Adam updates each at fp32 from the same converted
  JAX weights, held against the JAX ``Trainer`` on a (1, 1, 1, 2) mesh of
  the fake CPU devices (its Pallas kernels in interpret mode): losses
  within 2e-5 relative, parameters within rtol 5e-4 / atol 1e-6, the
  tolerances of ``tests/test_spmd_equivalence.py``;
* a target length (7) that does not divide by seq: the decoder runs whole
  on both ranks and counts once;
* ``remat='full'``, whose recompute replays the K/V gathers;
* dropout 0.1 on the all-gather path: every mask one process's (drawn at
  the full length and sliced, the kernels keyed on the global query), so
  the run equals one process's at dropout 0.1; it then restores a
  one-process checkpoint;
* ``train()`` under seq 2 with ``cache_frozen_features``: two epochs of two
  updates of the skewed synthetic rows, against one process's ``train()``,
  and its last checkpoint restored into one process.

Each of the first four is held against the port's one-process ``Trainer``
on the same rows too (losses, eval losses and parameters within 1e-5
relative), and its parameters, which both ranks hold whole, are bitwise
equal on the two ranks.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax

import _torch_port as tp
import klab_multimodalmodel_tpu_torch.config as tcfg
from _torch_ddp_worker import Job, loaders
from klab_multimodalmodel_tpu.train.trainer import Trainer as JaxTrainer
from klab_multimodalmodel_tpu.utils import make_mesh as jax_make_mesh
from klab_multimodalmodel_tpu_torch import __main__ as module_main
from klab_multimodalmodel_tpu_torch.checkpoint.from_jax import (
    convert_jax_params)
from klab_multimodalmodel_tpu_torch.checkpoint.io import (CheckpointManager,
                                                         read_whole)
from klab_multimodalmodel_tpu_torch.infer.captioner import Captioner
from klab_multimodalmodel_tpu_torch.ops.fused_attention import (
    draw_seed, t5_attention_bwd_plain, t5_attention_plain)
from klab_multimodalmodel_tpu_torch.text import ByteTokenizer
from klab_multimodalmodel_tpu_torch.train import Trainer, train
from klab_multimodalmodel_tpu_torch.train.loop import dropout_seed
from test_torch_sharded import B, TGT, WORKER, make_batch

SEQ = (1, 1, 1, 2)
JAX_LOSS_RTOL = 2e-5
JAX_PARAM_TOL = dict(rtol=5e-4, atol=1e-6)
TOL = 1e-5
DROP_T5 = "t5-torchport-tiny-dropout"
tcfg.register_t5_size(DROP_T5, tcfg.T5Size(**dict(tp.TINY_T5,
                                                  dropout_rate=0.1)))
SIZES = dict(t5_sizes={tp.T5_NAMES["v10"][0]: tp.TINY_T5,
                       DROP_T5: dict(tp.TINY_T5, dropout_rate=0.1)},
             swin_sizes={tp.SWIN_NAME: tp.TINY_SWIN})
# The port's runs against JAX, then against one process only.
JAX_RUNS = {"allgather_kernels": dict(),
            "ring": dict(seq_attention="ring",
                         use_pallas_t5_attention=False)}
PORT_RUNS = {"target_7": dict(max_target_length=7),
             "remat_full": dict(remat="full"),
             "dropout": dict(language_model_name=DROP_T5,
                             transformer_model_name=DROP_T5)}
LOOP_BATCH = 8


def _batches(target: int = TGT) -> list:
    return [{k: torch.as_tensor(v[:, :target] if k.startswith("target")
                                else v) for k, v in make_batch(s).items()}
            for s in (0, 1)]


def _one_process(cfg) -> Trainer:
    one = Trainer(dataclasses.replace(cfg, mesh_shape=(1, 1, 1)),
                  device="cpu")
    return one


def _jax_run(jc, params, batches) -> tuple[list, dict]:
    """Two updates of the JAX ``Trainer`` on a (1, 1, 1, 2) mesh."""
    jt = JaxTrainer(jc, jax_make_mesh(SEQ, devices=jax.devices()[:2]),
                    num_epochs=1)
    state = tp.jax_train_state(jt, params)
    losses = []
    for b in batches:
        state, loss = jt.train_step(state, jt.device_put_batch(
            {k: np.asarray(v) for k, v in b.items()}),
            jax.random.PRNGKey(7))
        losses.append(float(loss))
    return losses, jax.tree.map(np.asarray, jax.device_get(state.params))


@pytest.fixture(scope="module")
def interpret():
    """The JAX package's Pallas kernels in interpret mode (the CPU)."""
    from klab_multimodalmodel_tpu.ops import set_interpret

    set_interpret(True)
    yield
    set_interpret(False)


@pytest.fixture(scope="module")
def runs(tmp_path_factory, interpret):
    root = tmp_path_factory.mktemp("seq")
    base = dict(compute_dtype="float32", max_target_length=TGT,
                batch_size=B)
    jc, tc = tp.configs(kernels=True, **base)
    params = tp.jax_multimodal_params(jc, seed=0)
    converted = convert_jax_params(params, tc)
    torch.save(converted, root / "converted.pt")
    job_runs, ones = [], {}
    for name, overrides in {**JAX_RUNS, **PORT_RUNS}.items():
        _, cfg = tp.configs(kernels=True, **dict(base, **overrides))
        batches = _batches(cfg.max_target_length)
        torch.save(batches, root / f"{name}.batches.pt")
        one = _one_process(cfg)
        if name in JAX_RUNS:
            one.init_state(state_dict=converted)
            init = root / "converted.pt"
        else:
            one.init_state()
            init = root / f"{name}.init.pt"
            torch.save(one.model.state_dict(), init)
        gen = torch.Generator().manual_seed(dropout_seed(cfg.seed, 0))
        ones[name] = dict(
            losses=[float(one.train_step(b, gen)) for b in batches],
            evals=[float(one.eval_step(b)) for b in batches],
            params={n: p.detach().clone()
                    for n, p in one.model.named_parameters()})
        run = dict(config=dataclasses.asdict(dataclasses.replace(
                       cfg, mesh_shape=SEQ)),
                   init=str(init), batches=str(root / f"{name}.batches.pt"),
                   eval=str(root / f"{name}.batches.pt"),
                   result_dir=str(root / name), out=str(root / f"{name}.json"),
                   params=str(root / f"{name}.pt"),
                   local=str(root / f"{name}.local.{{rank}}.pt"))
        if name == "dropout":
            # A one-process checkpoint, restored by the seq-2 run.
            CheckpointManager(str(root / "one_dropout")).save(
                f"step_{one.step}", one)
            run["restore"] = str(root / "one_dropout")
        job_runs.append(run)
    loop_cfg = dataclasses.replace(
        tc, compute_dtype="float32", num_epochs=2, save_interval=1,
        cache_frozen_features=True, data_dir="synthetic",
        max_source_length=64, max_target_length=80, batch_size=LOOP_BATCH,
        mesh_shape=SEQ, result_dir=str(root / "loop"))
    loop_run = dict(n_train=16, n_val=8, global_batch=LOOP_BATCH)
    job_runs.append(dict(loop_run, loop=True,
                         config=dataclasses.asdict(loop_cfg),
                         out=str(root / "loop.json"),
                         params=str(root / "loop.{rank}.pt")))
    job = Job(root, job_runs, SIZES, nproc=2, script=WORKER)

    jax_runs = {}
    for name, overrides in JAX_RUNS.items():
        jcfg = dataclasses.replace(jc, **overrides)
        jax_runs[name] = _jax_run(jcfg, params, _batches())
    one_cfg = dataclasses.replace(loop_cfg, mesh_shape=(1, 1, 1),
                                  result_dir=str(root / "loop_one"))
    loop_one = train(one_cfg, *loaders(one_cfg, loop_run, 0, 1),
                     resume=False, device="cpu")
    job.wait()
    got = {}
    for name in {**JAX_RUNS, **PORT_RUNS}:
        with open(root / f"{name}.json") as f:
            got[name] = dict(json.load(f), **torch.load(root / f"{name}.pt"))
        got[name]["local"] = [torch.load(root / f"{name}.local.{r}.pt")
                              for r in range(2)]
    with open(root / "loop.json") as f:
        loop = json.load(f)
    loop["params"] = [torch.load(root / f"loop.{r}.pt") for r in range(2)]
    return dict(root=root, tc=tc, jax=jax_runs, one=ones, got=got,
                loop=loop, loop_one=loop_one, loop_cfg=loop_cfg)


@pytest.mark.parametrize("name", list(JAX_RUNS))
def test_seq2_trainer_matches_jax(runs, name):
    """Two updates at (1, 1, 1, 2) against the JAX ``Trainer`` on the same
    mesh: the all-gather path (JAX's XLA gathers; both kernel flags) and
    the ring (JAX's shard_map ring; the T5 kernel off)."""
    jlosses, jparams = runs["jax"][name]
    got = runs["got"][name]
    # The ring turned in the ring's run only: in the text tower's 2 and
    # the transformer's 4 self-attentions, 1 exchange forward (the frozen
    # tower's) or 1 forward and 2 backward; 2 steps, then 2 evals.
    assert got["ring_exchanges"] == (
        2 * (2 + 4 * 3) + 2 * (2 + 4) if name == "ring" else 0)
    np.testing.assert_allclose(got["losses"], jlosses, rtol=JAX_LOSS_RTOL)
    want = convert_jax_params(jparams, runs["tc"])
    for pname, w in want.items():
        if pname in got["params"]:
            np.testing.assert_allclose(got["params"][pname].numpy(),
                                       np.asarray(w), err_msg=pname,
                                       **JAX_PARAM_TOL)


@pytest.mark.parametrize("name", [*JAX_RUNS, *PORT_RUNS])
def test_seq2_trainer_matches_one_process(runs, name):
    """The same rows through one process: losses, eval losses and every
    parameter within 1e-5 relative (at dropout 0.1 too: the same stream);
    both ranks' parameters bitwise equal."""
    got, want = runs["got"][name], runs["one"][name]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=TOL)
    np.testing.assert_allclose(got["evals"], want["evals"], rtol=TOL)
    for pname, w in want["params"].items():
        rel = float((got["params"][pname] - w).norm()
                    / w.norm().clamp(min=1e-12))
        assert rel <= TOL, (pname, rel)
    r0, r1 = got["local"]
    assert set(r0) == set(r1) == set(want["params"])
    for n in r0:
        assert torch.equal(r0[n], r1[n]), n


def test_seq2_restores_a_one_process_checkpoint(runs):
    """The dropout run, after its steps, restores the one-process run's
    checkpoint: every tensor the one process wrote, bitwise."""
    restored = runs["got"]["dropout"]["restored"]
    want = runs["one"]["dropout"]["params"]
    for n, w in want.items():
        assert torch.equal(restored[n], w), n


def test_train_loop_under_seq2(runs):
    """``train()`` at seq 2 (both ranks read the same rows, the second
    epoch from the feature cache, which holds whole rows): per-epoch losses
    and ``min_val_loss`` are one process's, rank 0 wrote its checkpoints,
    and the last one restores bitwise into a one-process ``Trainer``."""
    got, one = runs["loop"], runs["loop_one"]
    assert got["steps"] == one["steps"] == 4
    for phase in ("train", "val"):
        np.testing.assert_allclose(got["losses"][phase],
                                   one["losses"][phase], rtol=TOL,
                                   err_msg=phase)
    assert got["min_val_loss"] == pytest.approx(one["min_val_loss"],
                                                rel=TOL)
    assert got["saves"] == [s["name"] for s in one["saves"]]
    r0, r1 = got["params"]
    for n in r0:
        assert torch.equal(r0[n], r1[n]), n
    cfg = dataclasses.replace(runs["loop_cfg"], mesh_shape=(1, 1, 1))
    trainer = Trainer(cfg, device="cpu")
    trainer.init_state()
    manager = CheckpointManager(cfg.result_dir)
    manager.restore(manager.latest(), trainer)
    for n, p in trainer.model.named_parameters():
        assert torch.equal(p.detach(), r0[n]), n


def test_seq2_run_directory_captions_in_one_process(runs, tmp_path, capsys):
    """Decode is free of ``seq``: the seq-2 run's directory (its config
    names mesh (1, 1, 1, 2)) loads into ``Captioner`` and the ``caption``
    command in one process, and both caption alike."""
    from PIL import Image

    from klab_multimodalmodel_tpu_torch.data.datasets import (
        load_image_resized)

    result = runs["loop_cfg"].result_dir
    with open(os.path.join(result, "config.json")) as f:
        config = tcfg.Config.from_json(f.read())
    assert config.mesh_shape[3] == 2
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lo,hi", [(0, 12), (12, 24), (5, 19)])
@pytest.mark.parametrize("h0,h1", [(0, 3), (1, 3)])
def test_plain_kernels_take_q_offset(dtype, lo, hi, h0, h1):
    """Rows [lo, hi) of heads [h0, h1) of the plain kernels' whole forward
    and backward, at rate 0.1, are the call on those rows and heads with
    ``q_offset = lo`` and ``head_offset = h0`` (a tensor x seq rank's; the
    rows' share of dk and dv: the whole call's with the other rows'
    upstream gradient 0); without the row offset the rows draw other keep
    bits."""
    g = torch.Generator().manual_seed(lo * 100 + hi)
    Bq, H, L, D = 2, 3, 24, 8
    q, k, v, do = (torch.randn(Bq, H, L, D, generator=g).to(dtype)
                   for _ in range(4))
    bias = torch.randn(H, L, L, generator=g)
    mask = torch.ones(Bq, L, dtype=torch.int32)
    mask[1, 17:] = 0
    seed = draw_seed(g)
    rows, heads = slice(lo, hi), slice(h0, h1)
    qh, kh, vh, doh = (t[:, heads] for t in (q, k, v, do))
    bh = bias[heads, rows]
    full = t5_attention_plain(q, k, v, bias, mask, 0.1, seed)
    part = t5_attention_plain(qh[:, :, rows], kh, vh, bh, mask, 0.1, seed,
                              head_offset=h0, q_offset=lo)
    assert torch.equal(part, full[:, heads, rows])
    unshifted = t5_attention_plain(qh[:, :, rows], kh, vh, bh, mask, 0.1,
                                   seed, head_offset=h0)
    if lo:
        assert not torch.equal(unshifted, full[:, heads, rows])
    do_rows = torch.zeros_like(do)
    do_rows[:, :, rows] = do[:, :, rows]
    want = t5_attention_bwd_plain(q, k, v, do_rows, bias, mask, 0.1, seed,
                                  True)
    got = t5_attention_bwd_plain(qh[:, :, rows], kh, vh, doh[:, :, rows],
                                 bh, mask, 0.1, seed, True, head_offset=h0,
                                 q_offset=lo)
    torch.testing.assert_close(got[0], want[0][:, heads, rows], rtol=0,
                               atol=0)
    for x, w in zip(got[1:3], want[1:3]):
        torch.testing.assert_close(x.float(), w[:, heads].float(),
                                   rtol=1e-5,
                                   atol=1e-5 if dtype == torch.float32
                                   else 2e-2)
    torch.testing.assert_close(got[3], want[3][heads, rows], rtol=0, atol=0)


@pytest.mark.parametrize("argv,error,match", [
    ("--mesh_shape 1 1 1 2", None, None),
    ("--mesh_shape 2 1 1 2 --seq_attention ring", None, None),
    ("--mesh_shape 1 2 1 2", None, None),
    ("--mesh_shape 1 1 2 2", None, None),
    ("--mesh_shape 1 1 1 2 --moe_experts 2", None, None),
    ("--mesh_shape 1 1 1 1 2 --pipeline_stages 2", None, None),
    ("--mesh_shape 1 1 1 1 1 2 --moe_experts 2", None, None),
    ("--mesh_shape 1 1 1 2 --seq_attention ring "
     "--use_pallas_t5_attention", ValueError, "kernel wins"),
    ("--mesh_shape 1 1 1 2 --pipeline_stages 2", ValueError, "seq"),
    ("--seq_attention ring --pipeline_stages 2", ValueError, "ring"),
    ("--seq_attention ring --use_pallas_t5_attention", None, None),
])
def test_seq_flags_parse_or_refuse(argv, error, match):
    """``--mesh_shape D 1 1 S``, ``seq`` beside ``fsdp`` or ``tensor`` and
    ``--seq_attention ring`` parse as the JAX package parses them, with
    MoE too; the ring beside the T5 kernel at seq > 1 (where the kernel
    wins and the ring never runs) raises; the JAX package's own refusals raise its
    messages (a pipeline with seq > 1, or with the ring)."""
    import klab_multimodalmodel_tpu.config as jcfg

    args = argv.split()
    if error is None:
        want, got = jcfg.parse_arguments(args), tcfg.parse_arguments(args)
        for name in ("mesh_shape", "seq_attention",
                     "use_pallas_t5_attention"):
            assert tuple(np.ravel(getattr(got, name))) == tuple(
                np.ravel(getattr(want, name))), name
        return
    with pytest.raises(error, match=match) as got:
        tcfg.parse_arguments(args)
    if error is ValueError and match != "kernel wins":
        with pytest.raises(ValueError) as want:
            jcfg.parse_arguments(args)
        assert str(got.value) == str(want.value)
