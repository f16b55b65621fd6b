"""Mixture-of-Experts routing and the experts' FFN, plain PyTorch.

The port of the JAX package's ``ops/moe.py``: a Switch (top-1) or GShard
(top-2) sparse MLP with dense dispatch. A fp32 router softmax picks each
token's experts; fixed-capacity ``(groups, tokens, experts, capacity)``
dispatch and combine tensors turn the sparse gather into three einsums with
static shapes. Tokens past an expert's capacity skip the MLP (the residual
carries them), and the Switch load-balancing loss pushes the router toward
uniform use. Routing is deterministic: the same batch routes the same way
every step.

The JAX package computes all of it with XLA einsums and no Pallas kernel,
so the port runs ``torch.einsum`` (cuBLAS batched GEMMs on the card). The
one-hot dispatch and combine tensors cost FLOPs and memory that an index
gather would not; they are kept as the JAX package has them. Where the
JAX package calls ``expert_constraint`` (the mesh's ``expert`` axis, and
the ``tensor`` axis on the banks' d_ff), ``moe_ffn`` takes an
``ExpertGroup`` (tensor x expert): the rank runs its slice of the experts
and of their d_ff columns, whose banks it holds, on the tokens every rank
of the group holds; the tensor group sums the experts' partial outputs
and the expert group the partial combine (``parallel/partitioning.py``).
Two sums a layer, not one over tensor x expert: a rank's partial output
of its columns would otherwise be combined before the sum over columns,
and the layer would round where one process does not.

Under sequence parallelism a routing group (a sequence) spans the ranks of
a seq group, each holding its positions (``SeqSlice``), where the JAX
package routes the whole group at its global shape. ``topk_routing`` then
takes the capacity of the full length and, in each of its ``top_k``
passes, gathers every seq rank's count of the tokens that chose each
expert (``seq_counts``, one all-gather of (G, E) a pass): the earlier
ranks' counts offset the rank's slots, so that slots are claimed in
sequence order as one process claims them, and the sum fills each
expert's used slots and the balance loss's routed fractions. The balance
loss is linear in the router's probabilities once those fractions are
global: each rank's is its positions' share, and the shares sum to one
process's value and gradient. ``moe_ffn`` needs no exchange over ``seq``:
a rank dispatches its own tokens into slots that no other rank claims;
the FFN (no bias, ReLU) leaves the empty slots 0.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..models.layers import dropout
from ..parallel.partitioning import (ExpertGroup, SeqSlice, expert_enter,
                                     expert_exit, grad_summed_over,
                                     seq_shard, sum_over_group)


def moe_capacity(num_tokens: int, num_experts: int, top_k: int,
                 capacity_factor: float) -> int:
    """Per-expert token capacity: ``ceil(top_k * S / E * factor)``, at
    least 1, at most S (an expert never receives a token of its group
    twice)."""
    cap = int(-(-top_k * num_tokens * capacity_factor // num_experts))
    return max(1, min(cap, num_tokens))


def seq_counts(counts: torch.Tensor, seq: SeqSlice) -> torch.Tensor:
    """(seq.size, *counts.shape): every seq rank's ``counts``, in seq order
    (``all_gather_into_tensor`` over the seq group)."""
    import torch.distributed as dist

    out = counts.new_empty((seq.size * counts.shape[0],)
                           + tuple(counts.shape[1:]))
    dist.all_gather_into_tensor(out, counts.contiguous(), group=seq.group)
    return out.view((seq.size,) + tuple(counts.shape))


def topk_routing(router_logits: torch.Tensor, top_k: int, capacity: int,
                 mask: Optional[torch.Tensor] = None,
                 seq: Optional[SeqSlice] = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense-dispatch top-k routing.

    ``router_logits`` (G, S, E), any float dtype (the softmax runs in
    fp32); ``mask`` (G, S), 1 for a real token: a masked token routes
    nowhere, claims no capacity and stays out of the balance statistics.

    Returns ``(combine, aux)``: ``combine`` (G, S, E, C) fp32 holds token
    (g, s)'s gate in expert e's slot c (zero where it was not routed or
    overflowed); ``aux`` is the Switch load-balancing loss (1.0 at perfect
    balance), over the nonempty groups and divided by ``top_k``.

    Each of the ``top_k`` passes takes every token's best remaining expert
    (argmax, first index on ties). A token's slot in its expert counts the
    tokens before it in sequence order that chose that expert in this pass,
    offset by the slots earlier passes filled.

    With ``seq`` the logits are positions ``seq.start ..`` of groups of
    ``seq.length`` (``mask`` is then the whole groups' (G, seq.length)
    mask): each pass's choice counts of every seq rank come from
    ``seq_counts``, ``combine`` holds the rank's rows of the whole
    routing's, and ``aux`` is the rank's share of
    the whole one (its positions' probabilities), the shares summing to
    it.
    """
    G, S, E = router_logits.shape
    dev = router_logits.device
    probs = torch.softmax(router_logits.float(), dim=-1)
    length = S if seq is None else seq.length
    whole = None if mask is None else mask.float()
    m = None if whole is None else seq_shard(whole, seq)
    n_real = (torch.full((G,), float(length), device=dev) if whole is None
              else whole.sum(dim=1).clamp(min=1.0))                # (G,)
    combine = torch.zeros((G, S, E, capacity), device=dev)
    remaining = probs
    used = torch.zeros((G, E), dtype=torch.int64, device=dev)
    frac_routed = torch.zeros((G, E), device=dev)
    for _ in range(top_k):
        index = remaining.argmax(dim=-1)                           # (G, S)
        gate = remaining.gather(-1, index[..., None])[..., 0]
        onehot = F.one_hot(index, E).float()                       # (G, S, E)
        if m is not None:
            onehot = onehot * m[:, :, None]
        ioh = (onehot > 0).long()
        total = onehot.sum(dim=1)                                  # (G, E)
        offset = used
        if seq is not None:
            # The earlier seq ranks' tokens take this pass's first slots.
            every = seq_counts(total, seq)                 # (ranks, G, E)
            offset = used + every[:seq.rank].sum(dim=0).long()
            total = every.sum(dim=0)
        pos_in_expert = (onehot.cumsum(dim=1) - onehot).long()
        pos = ((pos_in_expert * ioh).sum(-1)
               + (offset[:, None, :] * ioh).sum(-1))               # (G, S)
        fits = pos < capacity
        # One class past the last slot takes the overflowed tokens; it is
        # dropped (jax.nn.one_hot of an out-of-range index is all zeros).
        slot = F.one_hot(torch.where(fits, pos, capacity),
                         capacity + 1)[..., :capacity].float()     # (G, S, C)
        route = onehot[:, :, :, None] * slot[:, :, None, :]        # 0 or 1
        combine = combine + (gate * fits)[:, :, None, None] * route
        # The pass's tokens of expert e take its slots used .. used +
        # total - 1 in order; those below the capacity fit.
        used = (used + total.long()).clamp(max=capacity)
        frac_routed = frac_routed + total / n_real[:, None]
        remaining = remaining * (1.0 - onehot)
    # E * sum_e(f_e * P_e) on the full softmax (the router's gradient sees
    # every expert), averaged over the groups that hold a real token: an
    # all-padding group (a phantom row of the accumulation tail) adds
    # nothing and dilutes nothing.
    pm = probs if m is None else probs * m[:, :, None]
    mean_prob = pm.sum(dim=1) / n_real[:, None]                    # (G, E)
    n_groups = (float(G) if whole is None
                else whole.amax(dim=1).sum().clamp(min=1.0))
    aux = E * (frac_routed / top_k * mean_prob).sum(-1).sum() / n_groups
    return combine, aux


def balance_share(aux: torch.Tensor, mask: Optional[torch.Tensor],
                  rows: int, group=None) -> torch.Tensor:
    """``aux``, a balance loss averaged over this rank's nonempty groups
    (``topk_routing``'s, summed over layers), as this rank's share of the
    average over the nonempty groups of every rank of ``group``: times
    its nonempty groups (rows of ``mask`` with a real token, or ``rows``)
    over their sum across the group. Summed over the group, the shares
    are the one mean that the JAX package takes over the global batch.
    ``aux`` itself without a group."""
    if group is None:
        return aux
    import torch.distributed as dist

    n = (torch.full((), float(rows), device=aux.device) if mask is None
         else mask.float().amax(dim=1).sum())
    total = n.detach().clone()
    dist.all_reduce(total, group=group)
    return aux * (n / total.clamp(min=1.0))


def moe_ffn(x: torch.Tensor, combine: torch.Tensor, wi: torch.Tensor,
            wo: torch.Tensor, dropout_rate: float = 0.0,
            generator: Optional[torch.Generator] = None,
            expert: Optional[ExpertGroup] = None) -> torch.Tensor:
    """The experts' un-gated ReLU FFN over dense-dispatched tokens.

    ``x`` (G, S, D), ``combine`` (G, S, E, C) from ``topk_routing``, ``wi``
    (E, D, F) and ``wo`` (E, F, D), cast to x's dtype. Returns (G, S, D):
    each token's gate-weighted sum of its experts' outputs, zero for a
    token every expert dropped. Dropout after the ReLU draws from
    ``generator``. With ``expert`` the banks are this rank's experts
    ``expert.experts(E)`` and d_ff columns ``expert.columns(F)`` only: the
    dispatch, the FFN and the combine run on that slice; the tensor group
    sums the experts' partial outputs over their columns and the expert
    group the partial combine, each in fp32 and rounded once (and, in the
    backward, tensor x expert sums the partial gradient of ``x``, the
    expert group that of ``combine``). The dropout mask is drawn whole at
    (E, G, C, F) and sliced on E and F, so a rank keeps one process's."""
    E = combine.shape[2]
    mine = slice(0, E) if expert is None else expert.experts(E)
    # The tokens' gradient is partial on every rank of tensor x expert, the
    # combine weights' on every expert rank (each tensor rank's alike).
    x = expert_enter(x, expert)
    combine = grad_summed_over(
        combine, None if expert is None else expert.expert_group)[:, :, mine]
    dispatch = (combine > 0).to(x.dtype)
    # The JAX package's expert_constraint(expert_in).
    expert_in = torch.einsum("gsec,gsd->egcd", dispatch, x)
    h = F.relu(torch.einsum("egcd,edf->egcf", expert_in, wi.to(x.dtype)))
    if expert is not None:
        F_all = h.shape[-1] * expert.tensor
        h = dropout(h, dropout_rate, generator, [
            (0, mine.start, E), (3, expert.columns(F_all).start, F_all)])
    else:
        h = dropout(h, dropout_rate, generator)
    if expert is not None and expert.tensor > 1:
        # A tensor rank's d_ff columns: their partial products of the
        # x.dtype operands in fp32, summed over the tensor group and
        # rounded once, as one process's product over every column.
        expert_out = sum_over_group(torch.einsum(
            "egcf,efd->egcd", h.float(), wo.to(x.dtype).float()),
            expert.tensor_group).to(x.dtype)
    else:
        expert_out = torch.einsum("egcf,efd->egcd", h, wo.to(x.dtype))
    # And expert_constraint(expert_out).
    if expert is None or expert.expert_group is None:
        return torch.einsum("gsec,egcd->gsd", combine.to(x.dtype),
                            expert_out)
    # The experts' partials in fp32 (of the same x.dtype operands),
    # summed, then rounded once: one process's product accumulates every
    # expert in fp32 before its one rounding.
    return expert_exit(torch.einsum(
        "gsec,egcd->gsd", combine.to(x.dtype).float(), expert_out.float()),
        expert).to(x.dtype)
