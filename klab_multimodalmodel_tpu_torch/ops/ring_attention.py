"""Ring attention: sequence-parallel self-attention that streams K/V
around the ``seq`` group.

The port of the JAX package's ``ops/ring_attention.py``. The default
``seq`` path gathers the whole K/V on every rank (``parallel.partitioning.
seq_gather``), which costs O(L) memory per rank. Here each rank keeps its
K/V chunk; the chunks travel around the seq group (rank s sends to s + 1)
while a running softmax with an fp32 max, numerator and denominator folds
in one chunk per tick, so a rank holds O(L / S) of K/V (Liu et al., "Ring
Attention with Blockwise Transformers", 2023).

Semantics are ``models.layers.dot_product_attention``'s (no 1/sqrt(d)
scale, an additive fp32 bias, fp32 softmax statistics), computed in fp32
throughout as the JAX module's einsums are, and the output cast to q's
dtype. Dropout masks the numerator only while the denominator keeps the
undropped mass, which equals ``dropout(softmax(logits)) @ v`` row for row.
Its keep bits are the T5 kernels' Philox bits (``ops.fused_attention.
dropout_keep_mask``) at each element's global (b, h, q, k), from a seed
drawn from the step's generator: the ring at rate > 0 equals
``t5_attention_plain`` at that seed, and the backward draws the bits again
with no stored mask. Under tensor parallelism a rank holds heads
``head_offset ..`` of the whole, and its bits are keyed on those global
heads, so every tensor rank draws its heads' bits of one process's. (The JAX module folds per-(device, step) keys instead;
its stream, like every backend swap's, differs.)

The JAX module's backward is autodiff through ``scan`` + ``ppermute``. Here
point-to-point sends have no autograd, so ``RingAttentionFn`` writes it out:
a second ring in which K/V travel with their dK/dV accumulators while dq
and the bias rows' gradient stay local, the probabilities recomputed from
the saved ``lse = m + log(den)``. The forward saves q, its K/V chunk, the
output and lse. The per-tick products are ``torch.matmul``: the JAX module
runs XLA einsums there, no Pallas kernel.

The exchange is ``batch_isend_irecv``. Gloo refuses CUDA tensors for
point-to-point (``tools/torch_gloo_cuda_probe.py``), so with a gloo group
on the card (two ranks sharing one card, ``KLAB_CPU_COLLECTIVES=gloo``)
each exchange copies its chunk to the host and back, explicitly; over
NCCL, and on the CPU, the tensors go as they are.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from .fused_attention import dropout_keep_mask

# Exchanges made by this process (the counter a run reads to see that the
# ring turned).
exchanges = 0


def ring_applicable(q_len: int, k_len: int, mesh=None,
                    batch: Optional[int] = None,
                    num_heads: Optional[int] = None) -> bool:
    """The JAX ``ring_applicable`` gate on a port ``utils.mesh.Mesh`` (None:
    no mesh): a ``seq`` axis above 1, ``q_len == k_len`` and both dividing
    it, and, when given, the global ``batch`` dividing data x fsdp and
    ``num_heads`` dividing tensor."""
    if mesh is None or mesh.size("seq") == 1:
        return False
    n = mesh.size("seq")
    if batch is not None and batch % (mesh.size("data")
                                      * mesh.size("fsdp")):
        return False
    if num_heads is not None and num_heads % mesh.size("tensor"):
        return False
    return q_len % n == 0 and k_len % n == 0 and q_len == k_len


def _exchange(tensors: list, seq) -> list:
    """Each tensor sent to the next rank of the seq group, the previous
    rank's received in its place (one ``batch_isend_irecv``)."""
    global exchanges
    group, n, s = seq.group, seq.size, seq.rank
    staged = (tensors[0].is_cuda
              and dist.get_backend(group) == dist.Backend.GLOO)
    send = [t.contiguous() for t in tensors]
    if staged:
        send = [t.cpu() for t in send]
    recv = [torch.empty_like(t) for t in send]
    nxt = dist.get_global_rank(group, (s + 1) % n)
    prv = dist.get_global_rank(group, (s - 1) % n)
    ops = [dist.P2POp(dist.isend, t, nxt, group) for t in send]
    ops += [dist.P2POp(dist.irecv, t, prv, group) for t in recv]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    exchanges += 1
    if staged:
        dev = tensors[0].device
        return [t.to(dev, non_blocking=True) for t in recv]
    return recv


def _keep_scale(seed, rate: float, shape, seq, src: int,
                head_offset: int = 0) -> torch.Tensor:
    """The dropout factor (keep / (1 - rate), fp32) of this rank's query
    rows of its heads (the first is global head ``head_offset``) against
    key chunk ``src``, at their global indices."""
    keep = dropout_keep_mask(seed, rate, shape, head_offset=head_offset,
                             q_offset=seq.start, k_offset=src * shape[-1])
    return keep.to(torch.float32) / (1.0 - rate)


def _chunk_logits(q32, k, bias_rows, src: int, Lc: int) -> torch.Tensor:
    logits = torch.matmul(q32, k.float().transpose(-1, -2))
    if bias_rows is not None:
        logits = logits + bias_rows[..., src * Lc:(src + 1) * Lc].float()
    return logits


class RingAttentionFn(torch.autograd.Function):
    """The ring's forward and its written-out backward (see the module
    doc). Inputs: q (B,H,Lq,D) this rank's rows, k/v (B,H,Lc,D) its chunk,
    bias_rows (B|1,H,Lq,L) or None, seed (int64, one element) or None, the
    rate, the ``SeqSlice``, the global index of head 0."""

    @staticmethod
    def forward(ctx, q, k, v, bias_rows, seed, rate, seq, head_offset=0):
        n, Lc = seq.size, k.shape[2]
        B, H, Lq, D = q.shape
        q32 = q.float()
        m = torch.full((B, H, Lq), float("-inf"), device=q.device)
        num = torch.zeros((B, H, Lq, D), device=q.device)
        den = torch.zeros((B, H, Lq), device=q.device)
        k_cur, v_cur = k, v
        for t in range(n):
            # At tick t this rank holds chunk (s - t) mod n.
            src = (seq.rank - t) % n
            logits = _chunk_logits(q32, k_cur, bias_rows, src, Lc)
            m_new = torch.maximum(m, logits.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(logits - m_new[..., None])
            den = den * alpha + p.sum(-1)
            if rate > 0:
                p = p * _keep_scale(seed, rate, p.shape, seq, src,
                                    head_offset)
            num = num * alpha[..., None] + torch.matmul(p, v_cur.float())
            m = m_new
            if t + 1 < n:
                k_cur, v_cur = _exchange([k_cur, v_cur], seq)
        out32 = num / den[..., None]
        ctx.rate, ctx.seq, ctx.head_offset = rate, seq, head_offset
        ctx.save_for_backward(q, k, v, bias_rows, seed, out32,
                              m + torch.log(den))
        return out32.to(q.dtype)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, bias_rows, seed, out32, lse = ctx.saved_tensors
        rate, seq = ctx.rate, ctx.seq
        n, Lc = seq.size, k.shape[2]
        q32, do = q.float(), dout.float()
        delta = (do * out32).sum(-1, keepdim=True)
        dq = torch.zeros_like(q32)
        need_dbias = bias_rows is not None and ctx.needs_input_grad[3]
        dbias = (torch.zeros(bias_rows.shape, device=q.device)
                 if need_dbias else None)
        k_cur, v_cur = k, v
        dk = torch.zeros(k.shape, device=k.device)
        dv = torch.zeros(v.shape, device=v.device)
        for t in range(n):
            src = (seq.rank - t) % n
            logits = _chunk_logits(q32, k_cur, bias_rows, src, Lc)
            p = torch.exp(logits - lse[..., None])
            dp = torch.matmul(do, v_cur.float().transpose(-1, -2))
            p_num = p
            if rate > 0:
                scale = _keep_scale(seed, rate, p.shape, seq, src,
                                    ctx.head_offset)
                p_num = p * scale
                dp = dp * scale
            ds = p * (dp - delta)
            dv = dv + torch.matmul(p_num.transpose(-1, -2), do)
            dk = dk + torch.matmul(ds.transpose(-1, -2), q32)
            dq = dq + torch.matmul(ds, k_cur.float())
            if need_dbias:
                cols = dbias[..., src * Lc:(src + 1) * Lc]
                cols += ds.sum(0, keepdim=True) if dbias.shape[0] == 1 else ds
            if t + 1 < n:
                k_cur, v_cur, dk, dv = _exchange([k_cur, v_cur, dk, dv], seq)
        if n > 1:
            # The accumulators of chunk s are one hop from home.
            dk, dv = _exchange([dk, dv], seq)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dbias,
                None, None, None, None)


def ring_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bias_rows: Optional[torch.Tensor], seq,
                        dropout_rate: float = 0.0,
                        seed: Optional[torch.Tensor] = None,
                        head_offset: int = 0) -> torch.Tensor:
    """Sequence-parallel self-attention over the seq group of ``seq`` (a
    ``parallel.partitioning.SeqSlice``): q (B,H,Lq,D) this rank's query
    rows, k/v (B,H,Lc,D) its K/V chunk (Lq == Lc == L / S), ``bias_rows``
    (B|1,H,Lq,L) the additive fp32 bias of its rows against every key
    (relative position, causal and key-mask parts summed) at its heads,
    ``seed`` a one-element int64 tensor at rate > 0
    (``fused_attention.draw_seed``), ``head_offset`` the global index of
    head 0 (a tensor-parallel rank's first head), which the keep bits are
    keyed on.
    Returns this rank's rows of the output, in q's dtype. Gate call sites
    on ``ring_applicable``."""
    if dropout_rate > 0 and seed is None:
        raise ValueError("ring attention at rate > 0 needs a seed")
    if k.shape[2] != q.shape[2] or q.shape[2] != seq.rows:
        raise ValueError(f"ring attention: q rows {q.shape[2]}, K/V chunk "
                         f"{k.shape[2]}, expected {seq.rows} each")
    return RingAttentionFn.apply(q, k, v, bias_rows, seed,
                                 float(dropout_rate), seq, int(head_offset))
