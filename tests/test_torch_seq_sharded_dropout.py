"""Sequence parallelism beside FSDP2 and tensor parallelism, against one
process: dropout, an uneven target, checkpoints, held bytes and
``train()`` over four gloo ranks on the CPU; the ring's keep bits at a
tensor rank's heads without a job.

One torchrun job of 4 ranks runs, one after the other:

* dropout 0.1 at tensor 2 x seq 2 (1, 1, 2, 2) on the all-gather path
  with both kernel flags (the plain kernel versions keyed on the global
  head and the global query): every mask is one process's, so the run
  equals one process's at dropout 0.1; it then restores a one-process
  checkpoint;
* the same on the ring (``--seq_attention ring``, the T5 kernel off),
  whose self-attention drops with the T5 kernels' Philox bits at each
  element's global head, query and key. With the T5 kernel off one
  process's self-attention draws the generator's own masks instead, so
  its reference is one process whose self-attention drops with those
  Philox bits (``t5_attention_plain`` at a seed from the step's
  generator, ``philox_self_attention``): each tensor rank then draws its
  heads' bits of that process;
* fsdp 2 x seq 2 (1, 2, 1, 2) at a target length (7) that does not
  divide by seq: the decoder runs whole on both seq ranks and only seq
  rank 0 counts its tokens;
* ``train()`` at fsdp 2 x seq 2 with ``cache_frozen_features``: two epochs
  of two updates, each fsdp rank its chunk of the rows, against one
  process's ``train()``.

Each is held against the port's one-process ``Trainer`` on the same rows:
losses, eval losses, parameters and optimizer state within 1e-5 relative;
each rank holds ``per_rank_bytes``' reckoning; the fsdp 2 x seq 2
checkpoint restores bitwise into one process.
"""

import contextlib

import pytest
import torch

import _torch_port as tp
import _torch_split as ts
import klab_multimodalmodel_tpu_torch.config as tcfg
from klab_multimodalmodel_tpu_torch.models import t5 as t5_module
from klab_multimodalmodel_tpu_torch.ops.fused_attention import (
    draw_seed, dropout_keep_mask, t5_attention_plain)
from klab_multimodalmodel_tpu_torch.ops.ring_attention import (
    _keep_scale, ring_self_attention)
from klab_multimodalmodel_tpu_torch.parallel.partitioning import SeqSlice
from test_torch_pipe_sharded import assert_held_bytes

NPROC = 4
FSDP_SEQ = (1, 2, 1, 2)
TENSOR_SEQ = (1, 1, 2, 2)
DROP_T5 = "t5-torchport-tiny-dropout-seq-sharded"
tcfg.register_t5_size(DROP_T5, tcfg.T5Size(**dict(tp.TINY_T5,
                                                  dropout_rate=0.1)))
SIZES = dict(t5_sizes={tp.T5_NAMES["v10"][0]: tp.TINY_T5,
                       DROP_T5: dict(tp.TINY_T5, dropout_rate=0.1)},
             swin_sizes={tp.SWIN_NAME: tp.TINY_SWIN})
BASE = dict(kernels=True, compute_dtype="float32", max_target_length=ts.TGT,
            batch_size=ts.B)


@contextlib.contextmanager
def philox_self_attention():
    """One process whose plain self-attention drops its probabilities as
    the ring does: with the T5 kernels' Philox bits at a seed drawn from
    the step's generator (``t5_attention_plain``) instead of a mask drawn
    from it. Self-attention is told from cross-attention by its square
    logits (in the tiny cascade every cross-attention's query and key
    lengths differ)."""
    plain = t5_module.dot_product_attention

    def attend(q, k, v, bias=None, dropout_rate=0.0, generator=None, **kw):
        if dropout_rate > 0 and q.shape[2] == k.shape[2]:
            return t5_attention_plain(q, k, v, bias, None, dropout_rate,
                                      draw_seed(generator))
        return plain(q, k, v, bias=bias, dropout_rate=dropout_rate,
                     generator=generator, **kw)

    t5_module.dot_product_attention = attend
    try:
        yield
    finally:
        t5_module.dot_product_attention = plain


PORT_RUNS = {"dropout_allgather": dict(mesh_shape=TENSOR_SEQ,
                                       transformer_model_name=DROP_T5),
             "ring_rate01": dict(mesh_shape=TENSOR_SEQ,
                                 transformer_model_name=DROP_T5,
                                 seq_attention="ring",
                                 use_pallas_t5_attention=False,
                                 one_context=philox_self_attention),
             "target_7": dict(mesh_shape=FSDP_SEQ, max_target_length=7)}
MESHES = {name: kw["mesh_shape"] for name, kw in PORT_RUNS.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return ts.split_runs(tmp_path_factory.mktemp("seq_sharded_dropout"),
                         FSDP_SEQ, BASE, {}, PORT_RUNS, SIZES,
                         dict(mesh_shape=FSDP_SEQ), nproc=NPROC)


@pytest.mark.parametrize("name", list(PORT_RUNS))
def test_seq_sharded_runs_match_one_process(runs, name):
    """The same rows through one process: losses, eval losses, parameters
    and the optimizer's state within 1e-5 relative (at dropout 0.1 too:
    each tensor x seq rank draws its heads' and rows' part of one
    process's masks, on both seq backends; at target length 7 the seq
    ranks count the decoder's tokens once)."""
    ts.assert_matches_one_process(runs, name)
    exchanges = runs["got"][name]["ring_exchanges"]
    assert (exchanges > 0) == (name == "ring_rate01"), exchanges


def test_seq_sharded_checkpoints_restore_in_one_process(runs):
    """The fsdp 2 x seq 2 run's checkpoint restores bitwise into one
    process, optimizer state included; the dropout run (tensor 2 x seq 2)
    restored one process's checkpoint bitwise."""
    ts.assert_checkpoints_cross(runs, "target_7", "dropout_allgather")


@pytest.mark.parametrize("name", list(PORT_RUNS))
def test_seq_sharded_held_bytes_are_the_reckoning(runs, name):
    """The parameter bytes each rank holds are ``per_rank_bytes``'
    reckoning, which the seq axis leaves as it is, reckoned without a
    process group."""
    assert_held_bytes(runs, name, MESHES[name])


def test_train_loop_under_fsdp2_seq2(runs):
    """``train()`` at fsdp 2 x seq 2 (each fsdp rank its chunk of the rows,
    both seq ranks the same, the second epoch from the feature cache): one
    process's per-epoch losses, and the last checkpoint restores into one
    process."""
    ts.assert_loop_matches_one_process(runs)


@pytest.mark.parametrize("s,src,off", [(0, 0, 0), (1, 0, 2), (1, 1, 3),
                                       (0, 1, 1)])
def test_ring_keep_bits_take_the_global_head(s, src, off):
    """The ring's dropout factor of seq rank ``s``'s rows against key
    chunk ``src`` at heads ``off ..`` is the plain path's mask at those
    heads, rows and keys (the whole call's ``dropout_keep_mask``); at
    another head offset the bits differ."""
    g = torch.Generator().manual_seed(s * 10 + src + off)
    seed = draw_seed(g)
    B, H, L, n, rate = 2, 2, 24, 2, 0.1
    seq = SeqSlice(None, s, n, L)
    shape = (B, H, seq.rows, L // n)
    got = _keep_scale(seed, rate, shape, seq, src, off)
    whole = dropout_keep_mask(seed, rate, (B, H + off, L, L))
    keys = slice(src * shape[-1], (src + 1) * shape[-1])
    want = whole[:, off:off + H, seq.start:seq.start + seq.rows, keys]
    assert torch.equal(got, want.float() / (1.0 - rate))
    other = _keep_scale(seed, rate, shape, seq, src, off + 1)
    assert not torch.equal(got, other)


def test_ring_at_a_head_offset_equals_the_plain_heads():
    """A tensor rank's ring (one seq rank: no exchange) at rate 0.1 on
    heads 2 and 3 of 4 with ``head_offset`` 2 is the plain call's output at
    those heads, and its gradients autograd's of it."""
    g = torch.Generator().manual_seed(5)
    B, H, L, D, off = 2, 4, 12, 8, 2
    q, k, v, ct = (torch.randn(B, H, L, D, generator=g) for _ in range(4))
    bias = torch.randn(1, H, L, L, generator=g)
    seed = draw_seed(g)
    heads = slice(off, H)
    part = [t[:, heads].clone().requires_grad_() for t in (q, k, v)]
    bh = bias[:, heads].clone().requires_grad_()
    out = ring_self_attention(*part, bh, SeqSlice(None, 0, 1, L), 0.1,
                              seed, head_offset=off)
    out.backward(ct[:, heads])
    whole = [t.clone().requires_grad_() for t in (q, k, v)]
    bw = bias.clone().requires_grad_()
    want = t5_attention_plain(*whole, bw, None, 0.1, seed)
    want.backward(ct * (torch.arange(H) >= off).view(1, H, 1, 1))
    torch.testing.assert_close(out, want[:, heads], rtol=1e-5, atol=1e-6)
    for x, w in zip(part, whole):
        torch.testing.assert_close(x.grad, w.grad[:, heads], rtol=1e-5,
                                   atol=1e-6)
    torch.testing.assert_close(bh.grad, bw.grad[:, heads], rtol=1e-5,
                               atol=1e-6)
