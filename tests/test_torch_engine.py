"""The port's continuous-batching engine (``infer/engine.py``) and the
per-row decode it stands on (``models/t5.py`` ``decode_step`` with a (B,)
step):

- ``decode_step`` at per-row positions against the JAX package's, logits
  within ``LOGIT_TOL``, for a one-token step and a three-token chunk;
- ``DecodeEngine`` rows (staggered arrivals, recycled slots, per-row
  ``max_length``, a batched prefill) against the port's ``greedy_decode``
  of each request alone: equal, or a knife edge (the top-2 margin at the
  first differing step under ``KNIFE_EDGE`` relative, printed);
- one schedule against the JAX ``DecodeEngine``'s tokens;
- an idle slot ticked far past the buffer, then reused;
- sampled rows: the same seed gives the tokens of a batch-1
  ``sample_decode`` from that seed, whatever the slot-mates.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import _torch_port as tp
from klab_multimodalmodel_tpu.infer.engine import DecodeEngine as JEngine
from klab_multimodalmodel_tpu_torch.infer import generate as tgen
from klab_multimodalmodel_tpu_torch.infer.engine import DecodeEngine

# The JAX package's infer/__init__ exports a function named ``generate``.
jgen = importlib.import_module("klab_multimodalmodel_tpu.infer.generate")
jspec = importlib.import_module("klab_multimodalmodel_tpu.infer.speculative")

LOGIT_TOL = 1e-5
KNIFE_EDGE = 1e-5
SRC, MAX_LEN, D = 6, 12, 32


@pytest.fixture(scope="module")
def lm():
    return tp.jax_t5_lm("v11", eos_scale=4.0, src=SRC)


def _requests(model, rng, n):
    """n one-row requests: (enc, mask) with each its own trailing pads."""
    out = []
    for _ in range(n):
        enc = torch.from_numpy(rng.standard_normal((1, SRC, D)).astype(
            np.float32))
        mask = torch.ones(1, SRC, dtype=torch.int32)
        mask[:, SRC - int(rng.integers(0, 3)):] = 0
        out.append((enc, mask))
    return out


def _greedy(model, enc, mask, max_length=MAX_LEN):
    with torch.inference_mode():
        return tgen.greedy_decode(model, enc, mask, max_length)[0].numpy()


def _drain(engine, results, ticks=200):
    for _ in range(ticks):
        if not engine.has_live():
            return
        engine.tick()
        for tag, row, n in engine.reap():
            results[tag] = (row, n)
    raise AssertionError("the engine did not drain")


def _assert_greedy(model, req, row, want):
    """Equal to greedy, or a knife edge."""
    if not np.array_equal(row, want):
        s, margin = tp.first_difference_margin(model, *req, row, want)
        assert margin < KNIFE_EDGE, (s, margin, row, want)


@pytest.mark.parametrize("T", [1, 3])
def test_decode_step_at_per_row_positions_matches_jax(lm, T):
    """Prime the cache over 4 positions, then put every row at its own
    index (stale K/V past it) and decode a T-token chunk there."""
    jmodel, params, model = lm
    rng = np.random.default_rng(T)
    B, L = 3, 10
    enc = rng.standard_normal((B, SRC, D)).astype(np.float32)
    mask = np.ones((B, SRC), np.int32)
    mask[1, 4:] = 0
    tokens = rng.integers(2, 512, (B, L)).astype(np.int32)
    index = np.array([4, 2, 3])
    chunk = np.stack([tokens[b, index[b]:index[b] + T] for b in range(B)])

    _, jcache = jgen._init_cache(jmodel, params, enc, mask, tokens[:, :1], L)
    for s in range(1, 4):
        _, jcache = jgen._step(jmodel, params, jcache, tokens[:, s:s + 1],
                               jnp.asarray(s, jnp.int32), enc, mask, L)
    jcache = jspec._set_cache_index(jgen._broadcast_cache_index(jcache, B),
                                    jnp.asarray(index, jnp.int32))
    want, jcache = jspec._chunk_step(jmodel, params, jcache, chunk,
                                     jnp.asarray(index, jnp.int32), enc,
                                     mask, L)

    with torch.inference_mode():
        t_enc, t_mask = torch.from_numpy(enc), torch.from_numpy(mask)
        t_tok = torch.from_numpy(tokens)
        _, cache = tgen._init_cache(model, t_enc, t_mask, t_tok[:, :1], L)
        for s in range(1, 4):
            _, cache = tgen._step(model, cache, t_tok[:, s:s + 1], s, t_enc,
                                  t_mask, L)
        tgen._broadcast_cache_index(cache, B)
        for layer in cache:
            layer["self"]["cache_index"] = torch.from_numpy(index)
        got, cache = model.decode_step(torch.from_numpy(chunk),
                                       torch.from_numpy(index), t_enc, L,
                                       t_mask, cache=cache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)
    # The chunk's keys land at each row's own positions; the index moves.
    jkey = np.asarray(jcache["decoder"]["layers"]["block"]["SelfAttention"]
                      ["cached_key"])[0]       # layer 0: (B, H, L, D)
    for b in range(B):
        sl = slice(index[b], index[b] + T)
        np.testing.assert_allclose(
            cache[0]["self"]["cached_key"][b, :, sl].numpy(),
            jkey[b, :, sl], rtol=LOGIT_TOL, atol=LOGIT_TOL)
    assert cache[0]["self"]["cache_index"].tolist() == (index + T).tolist()


@pytest.mark.parametrize("T", [1, 3])
def test_per_row_cache_write_is_exact_at_and_past_the_buffer(lm, T):
    """Rows whose chunk lies inside the buffer, runs off its end, starts
    at its last position or past it: each in-buffer position takes its
    chunk token's key bitwise, every other position keeps its old value,
    and the keys returned are the buffer itself (written in place)."""
    model = lm[2]
    attn = model.decoder.block[0].layer[0]["SelfAttention"]
    rng = np.random.default_rng(10 + T)
    L = 6
    index = np.array([0, 2, L - 2, L - 1, L, L + 5])
    B = len(index)
    x = torch.from_numpy(rng.standard_normal((B, T, D)).astype(np.float32))
    with torch.inference_mode():
        k = attn._split_heads(attn.k(x))
        v = attn._split_heads(attn.v(x))
        # The buffer as decode allocates it: L positions and the spare one.
        old_k = torch.from_numpy(rng.standard_normal(
            (B, k.shape[1], L + 1, k.shape[3])).astype(np.float32))
        old_v = torch.from_numpy(rng.standard_normal(old_k.shape).astype(
            np.float32))
        cache = {"cached_key": old_k.clone(), "cached_value": old_v.clone(),
                 "cache_index": torch.from_numpy(index)}
        ck, cv, bias = attn._decode_kv(x, None, None, cache)
    want_k, want_v = old_k[:, :, :L].clone(), old_v[:, :, :L].clone()
    for b, i in enumerate(index):
        for t in range(T):
            if i + t < L:
                want_k[b, :, i + t] = k[b, :, t]
                want_v[b, :, i + t] = v[b, :, t]
    assert torch.equal(ck, want_k) and torch.equal(cv, want_v)
    assert bias.shape[-1] == L
    assert torch.equal(cache["cached_key"][:, :, :L], want_k)
    assert ck.data_ptr() == cache["cached_key"].data_ptr()
    assert cache["cache_index"].tolist() == (index + T).tolist()


def test_staggered_arrivals_recycled_slots_and_row_max(lm):
    """Five requests through three slots: two join, one joins mid-decode,
    two reuse reaped slots; requests 1 and 3 carry a shorter max_length."""
    _, _, model = lm
    reqs = _requests(model, np.random.default_rng(0), 5)
    row_max = [MAX_LEN, 6, MAX_LEN, 4, MAX_LEN]
    engine = DecodeEngine(model, slots=3, source_width=SRC, d_model=D,
                          max_length=MAX_LEN, chunk=2)
    results = {}

    def admit(i):
        pre = engine.prefill(*reqs[i])
        engine.insert(pre, *reqs[i], 0, tag=i, max_length=row_max[i])

    admit(0)
    admit(1)
    engine.tick()
    for t, r, n in engine.reap():
        results[t] = (r, n)
    admit(2)
    nxt = 3
    for _ in range(300):
        if not engine.has_live() and nxt == 5:
            break
        while engine.free_slots() and nxt < 5:
            admit(nxt)
            nxt += 1
        engine.tick()
        for t, r, n in engine.reap():
            results[t] = (r, n)
    assert sorted(results) == [0, 1, 2, 3, 4]
    eos_rows = 0
    for i, req in enumerate(reqs):
        row, n_valid = results[i]
        want = _greedy(model, *req, max_length=row_max[i])
        assert n_valid <= row_max[i]
        assert (row[row_max[i]:] == 0).all()
        _assert_greedy(model, req, row[:row_max[i]], want)
        eos_rows += int(1 in row[1:n_valid])
    assert eos_rows >= 1  # some row finished on eos, not on its length


def test_batched_prefill_rows_and_reap_before_tick(lm):
    """One three-row prefill into three slots; a slot freed by reap and
    refilled is not reaped again on the last tick's flags."""
    _, _, model = lm
    reqs = _requests(model, np.random.default_rng(1), 4)
    enc = torch.cat([r[0] for r in reqs[:3]])
    mask = torch.cat([r[1] for r in reqs[:3]])
    engine = DecodeEngine(model, slots=3, source_width=SRC, d_model=D,
                          max_length=MAX_LEN, chunk=3)
    pre = engine.prefill(enc, mask)
    for j in range(3):
        engine.insert(pre, enc, mask, j, tag=j, max_length=2 if j == 0
                      else MAX_LEN)
    engine.tick()
    reaped = engine.reap()
    assert 0 in [t for t, _, _ in reaped]
    results = {t: (r, n) for t, r, n in reaped}
    pre = engine.prefill(*reqs[3])
    engine.insert(pre, *reqs[3], 0, tag=3, max_length=2)
    assert 3 not in [t for t, _, _ in engine.reap()]
    _drain(engine, results)
    for i, req in enumerate(reqs):
        m = 2 if i in (0, 3) else MAX_LEN
        row, n_valid = results[i]
        _assert_greedy(model, req, row[:m], _greedy(model, *req, m))


def test_matches_jax_engine(lm):
    """The same weights, arrivals and ticks through the JAX
    ``DecodeEngine``: equal token rows."""
    jmodel, params, model = lm
    reqs = _requests(model, np.random.default_rng(2), 3)
    jeng = JEngine(jmodel, params, slots=2, source_width=SRC, d_model=D,
                   max_length=MAX_LEN, chunk=2)
    teng = DecodeEngine(model, slots=2, source_width=SRC, d_model=D,
                        max_length=MAX_LEN, chunk=2)
    out = {"jax": {}, "port": {}}
    for name, eng, conv in (("jax", jeng, lambda x: jnp.asarray(x.numpy())),
                            ("port", teng, lambda x: x)):
        def admit(i):
            enc, mask = (conv(x) for x in reqs[i])
            eng.insert(eng.prefill(enc, mask), enc, mask, 0, tag=i)

        admit(0)
        eng.tick()
        out[name].update({t: r for t, r, _ in eng.reap()})
        admit(1)
        for _ in range(100):
            if not eng.has_live() and len(out[name]) == 3:
                break
            if eng.free_slots() and len(out[name]) + int(
                    eng.active.sum()) < 3:
                admit(2)
            eng.tick()
            out[name].update({t: r for t, r, _ in eng.reap()})
    assert sorted(out["port"]) == [0, 1, 2]
    for i in range(3):
        np.testing.assert_array_equal(out["port"][i], out["jax"][i])


def test_idle_slot_ticked_past_the_buffer_then_reused(lm):
    """An empty slot's cache index grows by ``chunk`` every tick; far past
    the buffer it writes nothing and faults nothing, and a request
    inserted there afterwards decodes as greedy does."""
    _, _, model = lm
    reqs = _requests(model, np.random.default_rng(3), 3)
    engine = DecodeEngine(model, slots=2, source_width=SRC, d_model=D,
                          max_length=MAX_LEN, chunk=4)
    results = {}
    for i in range(2):
        engine.insert(engine.prefill(*reqs[i]), *reqs[i], 0, tag=i)
        _drain(engine, results)  # the other slot idles through every tick
    idle = engine.state.cache[0]["self"]["cache_index"]
    assert int(idle.max()) > MAX_LEN
    engine.insert(engine.prefill(*reqs[2]), *reqs[2], 0, tag=2)
    _drain(engine, results)
    for i, req in enumerate(reqs):
        _assert_greedy(model, req, results[i][0], _greedy(model, *req))


def test_insert_and_prefill_refusals(lm):
    _, _, model = lm
    enc, mask = _requests(model, np.random.default_rng(4), 1)[0]
    engine = DecodeEngine(model, slots=1, source_width=SRC, d_model=D,
                          max_length=MAX_LEN)
    with pytest.raises(ValueError, match="source width"):
        engine.prefill(enc[:, :4], mask[:, :4])
    pre = engine.prefill(enc, mask)
    with pytest.raises(ValueError, match="max_length"):
        engine.insert(pre, enc, mask, 0, tag=0, max_length=MAX_LEN + 1)
    engine.insert(pre, enc, mask, 0, tag=0)
    with pytest.raises(RuntimeError, match="no free slot"):
        engine.insert(pre, enc, mask, 0, tag=1)
    with pytest.raises(ValueError, match="chunk"):
        DecodeEngine(model, slots=1, source_width=SRC, d_model=D,
                     max_length=MAX_LEN, chunk=0)
    sampling = DecodeEngine(model, slots=1, source_width=SRC, d_model=D,
                            max_length=MAX_LEN, do_sample=True)
    with pytest.raises(ValueError, match="generator"):
        sampling.prefill(enc, mask)


WARPER = dict(temperature=0.8, top_k=50, top_p=0.9)


def test_sampled_rows_follow_their_own_seed(lm):
    """Sampled rows through shared ticks (staggered, a batched prefill,
    recycled slots) equal a batch-1 ``sample_decode`` from the same seed,
    whatever the slot-mates; the same seed twice gives the same tokens."""
    _, _, model = lm
    reqs = _requests(model, np.random.default_rng(5), 4)
    seeds = [11, 12, 13, 11]

    def gen(i):
        return torch.Generator().manual_seed(seeds[i])

    with torch.inference_mode():
        want = [tgen.sample_decode(model, *reqs[i], MAX_LEN, gen(i),
                                   **WARPER)[0].numpy() for i in range(4)]
    engine = DecodeEngine(model, slots=3, source_width=SRC, d_model=D,
                          max_length=MAX_LEN, chunk=2, do_sample=True,
                          **WARPER)
    results = {}
    g0 = gen(0)
    engine.insert(engine.prefill(*reqs[0], [g0]), *reqs[0], 0, tag=0,
                  generator=g0)
    engine.tick()
    results.update({t: (r, n) for t, r, n in engine.reap()})
    gs = [gen(1), gen(2), None]  # a padding row draws nothing
    enc = torch.cat([reqs[1][0], reqs[2][0], reqs[2][0]])
    mask = torch.cat([reqs[1][1], reqs[2][1], reqs[2][1]])
    pre = engine.prefill(enc, mask, gs)
    for j in range(2):
        engine.insert(pre, enc, mask, j, tag=j + 1, generator=gs[j])
    _drain(engine, results)
    g3 = gen(3)
    engine.insert(engine.prefill(*reqs[3], [g3]), *reqs[3], 0, tag=3,
                  generator=g3)
    _drain(engine, results)
    for i in range(4):
        np.testing.assert_array_equal(results[i][0], want[i],
                                      err_msg=f"request {i}")
    assert not np.array_equal(want[0], want[1])
