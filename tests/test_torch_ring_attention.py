"""The port's ring attention (``ops/ring_attention.py``) and the four-rank
layouts of sequence parallelism, over gloo ranks on the CPU.

One torchrun job of 4 ranks runs, one after the other:

* ``ring_self_attention`` on the cases of ``tests/test_ring_attention.py``
  (a plain, a causal and a batched key-masked bias; B 4, H 2, L 16, D 8,
  fp32) over the layouts (data, seq) (1, 2), (2, 2) and (1, 4), seq
  groups of consecutive ranks (a two-rank layout runs on ranks 0-1 and
  again on 2-3), each rank its rows of the output and of dq and the bias
  gradient and its chunks of dk and dv; held against the JAX
  ``ring_self_attention`` on ``make_mesh`` of the same layout and against
  JAX's autodiff of it;
* the same at dropout rate 0.1 with L 24 (key chunks of 12 and 6, which
  start inside a Philox counter's four words), held against
  ``t5_attention_plain`` at the same seed and its autograd: the ring draws
  the T5 kernels' keep bits at each element's global (b, h, q, k);
* the ``Trainer`` at mesh (2, 1, 1, 2) (data 2 x seq 2, the T5 kernel
  flag on: the plain kernel versions with ``q_offset``), two Adam updates
  from seeded weights, against the port's one-process step on the same
  rows (``test_torch_seq_parallel.py`` holds the two-rank layouts).

The ``ring_applicable`` gate is held against the JAX function on the same
shapes and meshes, with no job.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import _torch_port as tp
from _torch_ddp_worker import Job
from klab_multimodalmodel_tpu.models.layers import NEG_INF
from klab_multimodalmodel_tpu.ops import ring_attention as jring
from klab_multimodalmodel_tpu.utils import make_mesh as jax_make_mesh
from klab_multimodalmodel_tpu_torch.ops import ring_attention as tring
from klab_multimodalmodel_tpu_torch.ops.fused_attention import (
    t5_attention_plain)
from klab_multimodalmodel_tpu_torch.train import Trainer
from klab_multimodalmodel_tpu_torch.train.loop import dropout_seed
from klab_multimodalmodel_tpu_torch.utils.mesh import (DEFAULT_AXIS_NAMES,
                                                      Mesh, pad_mesh_shape)
from test_torch_sharded import B as TB, SIZES, TGT, WORKER, make_batch

B, H, L, D = 4, 2, 16, 8
L_DROP, RATE = 24, 0.1
LAYOUTS = {"seq2": (1, 2), "data2_seq2": (2, 2), "seq4": (1, 4)}
CASES = ("plain", "causal", "masked")
# JAX's own test's tolerances for the output; the gradients relative to
# the largest value.
OUT_TOL = dict(rtol=2e-5, atol=2e-6)
GRAD_TOL = 1e-5
TRAIN_TOL = 1e-4
TRAIN_MESH = (2, 1, 1, 2)


def _inputs(seed=0, causal=False, masked=False, length=L):
    """``tests/test_ring_attention.py``'s inputs, and the output's
    cotangent."""
    rng = np.random.RandomState(seed)
    q = rng.randn(B, H, length, D).astype(np.float32)
    k = rng.randn(B, H, length, D).astype(np.float32)
    v = rng.randn(B, H, length, D).astype(np.float32)
    bias = rng.randn(1, H, length, length).astype(np.float32)
    if causal:
        idx = np.arange(length)
        bias = bias + np.where(idx[:, None] >= idx[None, :], 0.0,
                               NEG_INF).astype(np.float32)
    if masked:
        kmask = (rng.rand(B, length) > 0.25).astype(np.float32)
        kmask[:, :2] = 1.0
        bias = (bias + np.where(kmask[:, None, None, :] > 0, 0.0, NEG_INF)
                ).astype(np.float32)
    ct = rng.randn(B, H, length, D).astype(np.float32)
    return dict(q=q, k=k, v=v, bias=bias, ct=ct)


def _drop_inputs():
    x = _inputs(seed=11, length=L_DROP)
    rng = np.random.RandomState(12)
    x["kmask"] = (rng.rand(B, L_DROP) > 0.25).astype(np.int32)
    x["kmask"][:, :2] = 1
    return x


def _torch_inputs(x: dict, rate: float = 0.0, seed=None) -> dict:
    out = {k: torch.from_numpy(v) for k, v in x.items() if k != "kmask"}
    if "kmask" in x:
        # The dense bias of t5_attention_plain's (bias_h, kmask).
        out["bias"] = out["bias"] + torch.where(
            torch.from_numpy(x["kmask"])[:, None, None, :] > 0, 0.0, -1e9)
    return dict(out, rate=rate, seed=seed)


def _gather(parts: list, layout) -> dict:
    """The whole output and gradients from every rank's part (the ranks of
    one layout; a two-rank layout's second copy is compared too)."""
    data, S = layout
    world = 4
    whole = {}
    for r in range(world):
        p = parts[r]
        b0, q0 = p["rows"]
        for name in ("out", "dq", "dk", "dv"):
            t = whole.setdefault((r // (data * S), name), torch.full(
                (B, H, S * p[name].shape[2], D), float("nan")))
            t[b0:b0 + p[name].shape[0], :, q0:q0 + p[name].shape[2]] = p[name]
        db = p["dbias"]
        t = whole.setdefault((r // (data * S), "dbias"), torch.zeros(
            (1 if db.shape[0] == 1 else B, H, S * db.shape[2], db.shape[3])))
        if db.shape[0] == 1:
            t[:, :, q0:q0 + db.shape[2]] += db
        else:
            t[b0:b0 + db.shape[0], :, q0:q0 + db.shape[2]] = db
    copies = sorted({c for c, _ in whole})
    return [{n: whole[(c, n)] for n in ("out", "dq", "dk", "dv", "dbias")}
            for c in copies]


def _jax_ring(x: dict, layout):
    """The JAX ring's output and gradients (q, k, v, bias) on a (data, 1,
    1, seq) mesh of the fake CPU devices."""
    data, S = layout
    mesh = jax_make_mesh((data, 1, 1, S), devices=jax.devices()[:data * S])
    ct = jnp.asarray(x["ct"])

    def loss(q, k, v, bias):
        return jnp.sum(jring.ring_self_attention(q, k, v, bias) * ct)

    with mesh:
        out = jax.jit(jring.ring_self_attention)(
            x["q"], x["k"], x["v"], x["bias"])
        grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3)))(
            x["q"], x["k"], x["v"], x["bias"])
    return [np.asarray(out)] + [np.asarray(g) for g in grads]


def _train_config(**kw):
    _, cfg = tp.configs(compute_dtype="float32", max_target_length=TGT,
                        batch_size=TB // 2, **kw)
    return cfg


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("ring")
    job_runs, expect = [], []
    for name, layout in LAYOUTS.items():
        for case in CASES:
            x = _inputs(seed=CASES.index(case), causal=case == "causal",
                        masked=case == "masked")
            torch.save(_torch_inputs(x), root / f"{name}.{case}.pt")
            job_runs.append(dict(ring=True, layout=layout,
                                 inputs=str(root / f"{name}.{case}.pt"),
                                 out=str(root / f"{name}.{case}.{{rank}}.pt")))
            expect.append((name, case, x))
        seed = torch.tensor([0x5EED_0000_1234 + layout[1]], dtype=torch.int64)
        torch.save(_torch_inputs(_drop_inputs(), RATE, seed),
                   root / f"{name}.drop.pt")
        job_runs.append(dict(ring=True, layout=layout,
                             inputs=str(root / f"{name}.drop.pt"),
                             out=str(root / f"{name}.drop.{{rank}}.pt")))
    # The Trainer at data 2 x seq 2 against one process.
    cfg = _train_config()
    one = Trainer(dataclasses.replace(cfg, mesh_shape=(1, 1, 1),
                                      batch_size=TB), device="cpu")
    one.init_state()
    torch.save(one.model.state_dict(), root / "init.pt")
    batches = [{k: torch.as_tensor(v) for k, v in make_batch(s).items()}
               for s in (0, 1)]
    torch.save(batches, root / "batches.pt")
    job_runs.append(dict(
        config=dataclasses.asdict(dataclasses.replace(
            cfg, mesh_shape=TRAIN_MESH)),
        init=str(root / "init.pt"), batches=str(root / "batches.pt"),
        eval=str(root / "batches.pt"), result_dir=str(root / "train"),
        out=str(root / "train.json"), params=str(root / "train.pt"),
        local=str(root / "train.local.{rank}.pt")))
    job = Job(root, job_runs, SIZES, nproc=4, script=WORKER)

    jax_out = {(name, case): _jax_ring(x, LAYOUTS[name])
               for name, case, x in expect}
    gen = torch.Generator().manual_seed(dropout_seed(cfg.seed, 0))
    want = dict(losses=[float(one.train_step(b, gen)) for b in batches],
                evals=[float(one.eval_step(b)) for b in batches],
                params={n: p.detach()
                        for n, p in one.model.named_parameters()})
    job.wait()
    got = {}
    for name, layout in LAYOUTS.items():
        for case in CASES + ("drop",):
            parts = [torch.load(root / f"{name}.{case}.{r}.pt")
                     for r in range(4)]
            got[(name, case)] = dict(copies=_gather(parts, layout),
                                     exchanges={p["exchanges"]
                                                for p in parts})
    with open(root / "train.json") as f:
        train = json.load(f)
    train.update(torch.load(root / "train.pt"))
    train["local"] = [torch.load(root / f"train.local.{r}.pt")
                      for r in range(4)]
    return dict(got=got, jax=jax_out, want=want, train=train)


@pytest.mark.parametrize("mesh_shape", [(1, 1, 1, 2), (2, 1, 1, 2),
                                        (1, 1, 1, 4), (2, 2, 2, 1),
                                        (2, 1, 1, 1), (2, 1, 2, 2),
                                        (1, 2, 1, 2), (1, 1, 2, 2),
                                        (1, 2, 2, 2)])
@pytest.mark.parametrize("q_len,k_len,batch,heads", [
    (16, 16, None, None), (16, 16, 4, 2), (16, 8, None, None),
    (6, 6, None, None), (16, 16, 3, None), (16, 16, None, 3)])
def test_ring_applicable_matches_jax(mesh_shape, q_len, k_len, batch,
                                     heads):
    n = int(np.prod(mesh_shape))
    with jax_make_mesh(mesh_shape, devices=jax.devices()[:n]):
        want = jring.ring_applicable(q_len, k_len, batch=batch,
                                     num_heads=heads)
    mesh = Mesh(shape=pad_mesh_shape(mesh_shape), axis_names=(
        DEFAULT_AXIS_NAMES), group=None, cpu_group=None)
    assert tring.ring_applicable(q_len, k_len, mesh, batch=batch,
                                 num_heads=heads) == want
    assert not tring.ring_applicable(q_len, k_len, None)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_ring_matches_jax(runs, layout, case):
    """Output within JAX's own tolerance; dq, dk, dv and the bias
    gradient within 1e-5 of the largest value of JAX's autodiff through
    its ring."""
    want = runs["jax"][(layout, case)]
    got = runs["got"][(layout, case)]
    # S - 1 exchanges forward, S backward.
    S = LAYOUTS[layout][1]
    assert got["exchanges"] == {2 * S - 1}
    for copy in got["copies"]:
        np.testing.assert_allclose(copy["out"].numpy(), want[0], **OUT_TOL)
        for name, w in zip(("dq", "dk", "dv", "dbias"), want[1:]):
            g = copy[name].numpy()
            err = np.abs(g - w).max() / np.abs(w).max()
            assert err <= GRAD_TOL, (name, err)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_ring_dropout_equals_t5_attention_plain(runs, layout):
    """At rate 0.1 the ring is ``t5_attention_plain`` at the same seed
    (the keep bits of each element's global query and key, also where a
    key chunk starts inside a counter's four words), and its gradients are
    autograd's of that call. A data rank's call holds its own rows, whose
    batch index starts at 0 (each data rank draws its own seeds), so the
    reference is one call per data rank's rows."""
    x = _drop_inputs()
    seed = torch.tensor([0x5EED_0000_1234 + LAYOUTS[layout][1]],
                        dtype=torch.int64)
    q, k, v, bias_h = (torch.from_numpy(x[n]).requires_grad_()
                       for n in ("q", "k", "v", "bias"))
    kmask, ct = torch.from_numpy(x["kmask"]), torch.from_numpy(x["ct"])
    n = B // LAYOUTS[layout][0]
    outs = []
    for lo in range(0, B, n):
        rows = slice(lo, lo + n)
        out = t5_attention_plain(q[rows], k[rows], v[rows], bias_h[0],
                                 kmask[rows], RATE, seed)
        out.backward(ct[rows])
        outs.append(out.detach())
    want = dict(out=torch.cat(outs), dq=q.grad, dk=k.grad, dv=v.grad,
                dbias=bias_h.grad)
    for copy in runs["got"][(layout, "drop")]["copies"]:
        for name, w in want.items():
            g = copy[name]
            if name == "dbias":
                g = g.sum(0, keepdim=True)
            err = float((g - w).abs().max() / w.abs().max())
            assert err <= GRAD_TOL, (name, err)


def test_trainer_at_data2_seq2_matches_one_process(runs):
    """Two Adam updates of the Trainer at data 2 x seq 2 (each data rank
    its 4 rows, each seq rank its positions of every stack; the kernel
    flags on) and its eval losses equal the one process's on the same
    global rows; the parameters, which every rank holds whole, are bitwise
    equal on all four ranks."""
    got, want = runs["train"], runs["want"]
    assert got["dp"] == [0, 2]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=TRAIN_TOL)
    np.testing.assert_allclose(got["evals"], want["evals"], rtol=TRAIN_TOL)
    for pname, w in want["params"].items():
        rel = float((got["params"][pname] - w).norm()
                    / w.norm().clamp(min=1e-12))
        assert rel <= TRAIN_TOL, (pname, rel)
    first = got["local"][0]
    for other in got["local"][1:]:
        for n, p in first.items():
            assert torch.equal(p, other[n]), n
