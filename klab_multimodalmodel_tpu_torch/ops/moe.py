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
JAX package calls ``expert_constraint`` (the mesh's ``expert`` axis),
``moe_ffn`` takes an ``ExpertGroup``: the rank runs its slice of the
experts, whose banks it holds, on the tokens every rank of the group
holds, and the group sums the partial combine (``parallel/partitioning.py``
``expert_enter`` / ``expert_exit``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..models.layers import dropout
from ..parallel.partitioning import ExpertGroup, expert_enter, expert_exit


def moe_capacity(num_tokens: int, num_experts: int, top_k: int,
                 capacity_factor: float) -> int:
    """Per-expert token capacity: ``ceil(top_k * S / E * factor)``, at
    least 1, at most S (an expert never receives a token of its group
    twice)."""
    cap = int(-(-top_k * num_tokens * capacity_factor // num_experts))
    return max(1, min(cap, num_tokens))


def topk_routing(router_logits: torch.Tensor, top_k: int, capacity: int,
                 mask: Optional[torch.Tensor] = None
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
    """
    G, S, E = router_logits.shape
    dev = router_logits.device
    probs = torch.softmax(router_logits.float(), dim=-1)
    m = None if mask is None else mask.float()
    n_real = (torch.full((G,), float(S), device=dev) if m is None
              else m.sum(dim=1).clamp(min=1.0))                    # (G,)
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
        pos_in_expert = (onehot.cumsum(dim=1) - onehot).long()
        pos = ((pos_in_expert * ioh).sum(-1)
               + (used[:, None, :] * ioh).sum(-1))                 # (G, S)
        fits = pos < capacity
        # One class past the last slot takes the overflowed tokens; it is
        # dropped (jax.nn.one_hot of an out-of-range index is all zeros).
        slot = F.one_hot(torch.where(fits, pos, capacity),
                         capacity + 1)[..., :capacity].float()     # (G, S, C)
        route = onehot[:, :, :, None] * slot[:, :, None, :]        # 0 or 1
        combine = combine + (gate * fits)[:, :, None, None] * route
        used = used + (ioh * fits[:, :, None]).sum(dim=1)
        frac_routed = frac_routed + onehot.sum(dim=1) / n_real[:, None]
        remaining = remaining * (1.0 - onehot)
    # E * sum_e(f_e * P_e) on the full softmax (the router's gradient sees
    # every expert), averaged over the groups that hold a real token: an
    # all-padding group (a phantom row of the accumulation tail) adds
    # nothing and dilutes nothing.
    pm = probs if m is None else probs * m[:, :, None]
    mean_prob = pm.sum(dim=1) / n_real[:, None]                    # (G, E)
    n_groups = (float(G) if m is None
                else m.amax(dim=1).sum().clamp(min=1.0))
    aux = E * (frac_routed / top_k * mean_prob).sum(-1).sum() / n_groups
    return combine, aux


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
    ``expert.experts(E)`` only: the dispatch, the FFN and the combine run
    on that slice of the E axis, and the group sums the partial combine in
    fp32 (and, in the backward, the partial gradients of ``x`` and
    ``combine``). The dropout mask is drawn whole at (E, G, C, F) and
    sliced, so a rank keeps one process's."""
    E = combine.shape[2]
    mine = slice(0, E) if expert is None else expert.experts(E)
    x = expert_enter(x, expert)
    combine = expert_enter(combine, expert)[:, :, mine]
    dispatch = (combine > 0).to(x.dtype)
    # The JAX package's expert_constraint(expert_in).
    expert_in = torch.einsum("gsec,gsd->egcd", dispatch, x)
    h = F.relu(torch.einsum("egcd,edf->egcf", expert_in, wi.to(x.dtype)))
    h = dropout(h, dropout_rate, generator,
                None if expert is None else (0, mine.start, E))
    expert_out = torch.einsum("egcf,efd->egcd", h, wo.to(x.dtype))
    # And expert_constraint(expert_out).
    if expert is None:
        return torch.einsum("gsec,egcd->gsd", combine.to(x.dtype),
                            expert_out)
    # The partials in fp32 (of the same x.dtype operands), summed, then
    # rounded once: one process's product accumulates every expert in fp32
    # before its one rounding.
    return expert_exit(torch.einsum(
        "gsec,egcd->gsd", combine.to(x.dtype).float(), expert_out.float()),
        expert).to(x.dtype)
