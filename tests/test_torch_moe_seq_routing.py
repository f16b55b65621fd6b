"""MoE routing split over seq slices (``ops/moe.py`` under sequence
parallelism), with no process group: each slice routes its positions of
the groups in a thread of its own, and the all-gather of the slices'
choice counts is a plain function of what the threads hand in
(``Exchange``).

- ``topk_routing`` over 2 and 4 slices, top-1 and top-2, with no mask,
  pads at the end, pads at the start and an all-padding row: each slice's
  combine rows are the whole routing's rows, bitwise in fp32; the slices'
  balance losses sum to the whole one; the router's gradient summed over
  the slices is the whole one's;
- an expert that every token prefers fills on slice 0, and the later
  slices' tokens overflow it, as in the whole routing;
- ``T5MoeMlp`` at dropout 0.1: each slice's output rows are the whole
  layer's (the FFN needs no exchange: a slice's tokens take slots no other
  slice claims, and the dropout mask is drawn whole).
"""

import threading

import numpy as np
import pytest
import torch

from klab_multimodalmodel_tpu_torch.config import T5Size
from klab_multimodalmodel_tpu_torch.models import t5 as tt5
from klab_multimodalmodel_tpu_torch.ops import moe as tmoe
from klab_multimodalmodel_tpu_torch.parallel.partitioning import SeqSlice

G, S, E, D = 3, 16, 4, 8
TIMEOUT = 30.0


class Exchange:
    """``seq_counts`` for slices in threads: every slice's counts, in
    slice order, once all of them have handed theirs in."""

    def __init__(self, n: int):
        self.box = [None] * n
        self.barrier = threading.Barrier(n, timeout=TIMEOUT)

    def __call__(self, counts, seq):
        self.box[seq.rank] = counts.clone()
        self.barrier.wait()
        every = torch.stack(self.box)
        self.barrier.wait()  # nobody hands in the next pass's before
        return every


def in_threads(n: int, fn) -> list:
    """``fn(rank)`` for each of ``n`` slices, each in its own thread."""
    out, errors = [None] * n, []

    def run(r):
        try:
            out[r] = fn(r)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors.append(e)
    threads = [threading.Thread(target=run, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(TIMEOUT)
    assert not any(t.is_alive() for t in threads), "a slice hung"
    if errors:
        raise errors[0]
    return out


def make_mask(kind: str):
    if kind == "unmasked":
        return None
    mask = np.ones((G, S), np.float32)
    if kind == "pads_end":
        mask[0, 12:] = 0
        mask[1, 9:] = 0
    elif kind == "pads_start":
        mask[0, :5] = 0
        mask[2, :11] = 0
    elif kind == "all_pad_row":
        mask[1] = 0
        mask[2, 14:] = 0
    return torch.from_numpy(mask)


def inputs(seed: int, favourite: bool = False):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((G, S, D)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((E, D)).astype(np.float32))
    if favourite:
        # Every token prefers expert 0 by far: it fills on slice 0.
        x = torch.cat([x[..., :-1], torch.full((G, S, 1), 8.0)], dim=-1)
        w[:, -1] = 0.0
        w[0, -1] = 1.0
    ct = torch.from_numpy(rng.standard_normal((G, S, E)).astype(np.float32))
    return x, w, ct


def whole_and_split(n, top_k, capacity, mask, x, w, ct):
    """The whole routing and its ``n`` slices (``seq_counts`` an
    ``Exchange``: monkeypatch it first): (combine, aux, the router
    weight's gradient of aux plus a cotangent of the combine summed over
    the slots) of each."""
    def route(r):
        seq = None if r is None else SeqSlice(None, r, n, S)
        rows = slice(None) if seq is None else slice(seq.start,
                                                     seq.start + seq.rows)
        wr = w.clone().requires_grad_()
        # The whole product, then the rows: the same logits' bits on every
        # slice (a product of fewer rows may round otherwise).
        logits = torch.einsum("gsd,ed->gse", x, wr)[:, rows]
        combine, aux = tmoe.topk_routing(logits, top_k, capacity, mask=mask,
                                         seq=seq)
        (aux + (combine.sum(-1) * ct[:, rows]).sum()).backward()
        return combine.detach(), aux.detach(), wr.grad
    return route(None), in_threads(n, route)


@pytest.mark.parametrize("kind", ["unmasked", "pads_end", "pads_start",
                                  "all_pad_row"])
@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("n", [2, 4])
def test_seq_slices_route_as_the_whole(n, top_k, kind, monkeypatch):
    """Each slice's combine rows are the whole routing's, bitwise; the
    balance losses and the router's gradients sum to the whole ones."""
    monkeypatch.setattr(tmoe, "seq_counts", Exchange(n))
    x, w, ct = inputs(10 * n + top_k)
    cap = tmoe.moe_capacity(S, E, top_k, 1.25)
    (c, aux, grad), parts = whole_and_split(n, top_k, cap, make_mask(kind),
                                            x, w, ct)
    rows = S // n
    for r, (cr, _, _) in enumerate(parts):
        assert torch.equal(cr, c[:, r * rows:(r + 1) * rows]), r
    torch.testing.assert_close(sum(p[1] for p in parts), aux, rtol=1e-6,
                               atol=1e-7)
    torch.testing.assert_close(sum(p[2] for p in parts), grad, rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("n", [2, 4])
def test_an_expert_full_on_slice_0_overflows_the_later_slices(
        n, top_k, monkeypatch):
    """Every token's first choice is expert 0: at a capacity of half a
    slice's positions, slice 0's tokens fill it, and the later slices'
    tokens overflow it (no slot of expert 0), as in the whole routing."""
    monkeypatch.setattr(tmoe, "seq_counts", Exchange(n))
    x, w, ct = inputs(7 + n, favourite=True)
    # Expert 0 fills within slice 0's positions.
    cap = S // n // 2
    (c, aux, grad), parts = whole_and_split(n, top_k, cap, None, x, w, ct)
    rows = S // n
    first = parts[0][0][:, :, 0]
    assert int((first > 0).sum()) == G * cap
    for r, (cr, _, _) in enumerate(parts):
        assert torch.equal(cr, c[:, r * rows:(r + 1) * rows]), r
        if r:
            assert not (cr[:, :, 0] > 0).any(), r
    torch.testing.assert_close(sum(p[1] for p in parts), aux, rtol=1e-6,
                               atol=1e-7)
    torch.testing.assert_close(sum(p[2] for p in parts), grad, rtol=1e-5,
                               atol=1e-6)


SIZE = T5Size(d_model=D, d_kv=4, d_ff=12, num_layers=1,
              num_decoder_layers=1, num_heads=2, vocab_size=32,
              dropout_rate=0.1)


@pytest.mark.parametrize("n", [2, 4])
def test_moe_layer_slices_are_the_whole_layer(n, monkeypatch):
    """``T5MoeMlp`` at dropout 0.1 on each slice's positions (the capacity
    of the full length, the whole mask): its output rows are the whole
    layer's within 1e-6 and its balance losses sum to the whole one."""
    layer = tt5.T5MoeMlp(SIZE, E, top_k=2)
    layer.init_weights(torch.Generator().manual_seed(3))
    x, _, _ = inputs(5)
    mask = make_mask("pads_end")

    def run(r):
        seq = None if r is None else SeqSlice(None, r, n, S)
        part = x if seq is None else x[:, seq.start:seq.start + seq.rows]
        gen = torch.Generator().manual_seed(11)
        with torch.no_grad():
            return layer(part, deterministic=False, generator=gen,
                         mask=mask, seq=seq)
    monkeypatch.setattr(tmoe, "seq_counts", Exchange(n))
    y, aux = run(None)
    parts = in_threads(n, run)
    rows = S // n
    for r, (yr, _) in enumerate(parts):
        torch.testing.assert_close(yr, y[:, r * rows:(r + 1) * rows],
                                   rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(sum(a for _, a in parts), aux, rtol=1e-6,
                               atol=1e-7)
