"""Mixture-of-Experts feed-forward with expert parallelism (EP).

Counterpart of ``picklebot_tpu/ops/moe.py``: MobileViT's transformer FFN
(bias-free Linear -> SiLU -> Dropout -> Linear -> Dropout, no pre-norm)
as a bank of ``n_experts`` such MLPs behind a top-1 or top-2 router with a
fixed ``capacity`` of token slots per expert and routing group. The JAX
module routes by one-hot dispatch and combine einsums; this one routes by
index, with the same arithmetic:

  * Routing in f32 whatever the compute dtype: softmax gates; the top-1
    expert by argmax of the gates, the top-2 by argmax of the logits with
    the top-1 masked to -inf (both take the first maximum on a tie, as
    ``jnp.argmax`` does); each token's slot is its place in its expert's
    queue within the group (a cumsum over the tokens), top-2 slots queue
    behind every top-1 slot of the group; top-2 gates are renormalised by
    g1 + g2 + 1e-9.
  * Dispatch: each kept token's row is written into its (expert, group,
    slot) place of an (E, g, cap, d) slot tensor, combine reads the
    experts' outputs back from those places with the gates as weights.
    A token whose slot is past the capacity is dropped: the JAX one-hot of
    a position >= cap is a zero row, so the token's weight and its
    contribution are zero, and here it is written to a row of its own past
    the slots and read with weight zero. The (g, n, E, cap) one-hot
    tensors are never built (at MobileViT-s stage 1, bs 8, E 4, top-2:
    393 MB each in f32).
  * Expert MLPs in the compute dtype, on every slot (an empty slot is a
    zero row, as in the JAX module).
  * The load-balance loss E * sum_e frac_e * prob_e (the top-1 assignment
    fractions and mean gates) is a per-forward value: ``aux_loss`` holds
    the last forward's, a tensor in the graph, outside ``state_dict`` (a
    forward without autograd, as serving and export run, leaves None); the
    train step adds ``moe_aux_weight`` times the sum of them to each
    microbatch's backward loss and reads it before the backward, so under
    remat the value of the kept forward counts, not the recompute's.

Layout: ``router`` (E, d), ``w1`` (h, d, E) and ``w2`` (d, h, E): the
JAX (d, E), (E, d, h) and (E, h, d) leaves with every axis reversed, the
names and layouts that the JAX package's ``.pth`` export writes, so each
package loads the other's file strictly.

``expert_axis`` (an axis of more than one rank) shards ``w1`` and ``w2``
on their expert dim over it; the router stays whole. Two dispatch modes:

  * ``replicated``: every rank routes all the tokens and runs its own
    experts' slots; the input and the router enter through Megatron's f
    (``tp_copy_in``: their gradients summed over the axis) and the output
    leaves through g (``tp_reduce_out``). Every rank computes the whole
    aux loss, so its gradient would enter those sums once per rank: the
    differentiable part is scaled by 1/size, the value kept whole. Equal
    to the unsharded module.
  * ``tokens``: the tokens are scattered over the axis
    (``sp_scatter_tokens``), each rank routes its own block as its groups
    (capacity from the block's token count), two counted all-to-alls move
    the (E, g, cap, d) slots to their experts' ranks, (E/size, size*g,
    cap, d), and back, and the tokens are gathered at exit. The aux value
    comes from the fractions and gates averaged over the ranks (one
    all-reduce, outside the graph); its gradient flows through the local
    gates' term scaled by 1/size, which the router's sum over the axis
    turns into the grouped reference's. Equal to the unsharded module
    applied to the tokens regrouped per rank. Dropout draws from a stream
    keyed by the rank. A token count that does not split falls back to
    ``replicated`` with a warning (MobileViT-s stage 2, N = 147).
"""

from __future__ import annotations

import contextlib
import math
import warnings

import torch
import torch.nn.functional as F
from torch import nn

from picklebot_tpu_torch.ops import activations as act
from picklebot_tpu_torch.ops.linear import (Dropout, current_dropout_rng,
                                            keyed_stream)
from picklebot_tpu_torch.parallel import mesh
from picklebot_tpu_torch.parallel.megatron import (shard_tensor, tp_copy_in,
                                                   tp_reduce_out)
from picklebot_tpu_torch.parallel.sequence import (sp_gather_tokens,
                                                   sp_scatter_tokens)

_INIT_STD = 0.02


class _AllToAll(torch.autograd.Function):
    """``mesh.all_to_all``, with the inverse exchange as its backward."""

    @staticmethod
    def forward(ctx, x, axis, split_dim, concat_dim):
        ctx.args = axis, split_dim, concat_dim
        return mesh.all_to_all(x, axis, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        axis, split_dim, concat_dim = ctx.args
        return mesh.all_to_all(g, axis, concat_dim, split_dim), None, None, \
            None


class MoEFeedForward(nn.Module):
    def __init__(self, embed_dim, hidden_dim, n_experts, top_k=2,
                 capacity_factor=1.25, dropout=0.0, expert_axis=None,
                 dispatch="replicated"):
        super().__init__()
        if not 1 <= top_k <= min(2, n_experts):
            raise ValueError(f"top_k={top_k} (n_experts={n_experts}): "
                             "top-1 and top-2 routing are supported")
        if dispatch not in ("replicated", "tokens"):
            raise ValueError(f"dispatch={dispatch!r}: 'replicated' (equal "
                             "to the unsharded module) or 'tokens' "
                             "(all-to-all exchange, rank-local groups)")
        size = mesh.axis_size(expert_axis) if expert_axis else 1
        if n_experts % size:
            raise ValueError(f"{n_experts} experts do not split over the "
                             f"{size} ranks of '{expert_axis}'")
        self.n_experts, self.top_k = n_experts, top_k
        self.capacity_factor = capacity_factor
        self.expert_axis = expert_axis if size > 1 else None
        self.dispatch = dispatch
        self.dropout = dropout
        e_local = n_experts // size
        self.router = nn.Parameter(torch.empty(n_experts, embed_dim))
        self.w1 = nn.Parameter(torch.empty(hidden_dim, embed_dim, e_local))
        self.w2 = nn.Parameter(torch.empty(embed_dim, hidden_dim, e_local))
        self.drop1 = Dropout(dropout)
        self.drop2 = Dropout(dropout)
        self.sharded = ({"w1": ("expert", 2), "w2": ("expert", 2)}
                        if self.expert_axis else {})
        self.aux_loss = None

    def reset_parameters(self, generator: torch.Generator):
        """N(0, 0.02^2) from ``generator``: the router, then the whole
        ``w1`` and ``w2`` banks, of which a sharded module keeps its
        rank's experts (so its weights are the one-process module's)."""
        with torch.no_grad():
            self.router.normal_(0.0, _INIT_STD, generator=generator)
            for w in (self.w1, self.w2):
                full = torch.empty(tuple(w.shape[:2]) + (self.n_experts,))
                full.normal_(0.0, _INIT_STD, generator=generator)
                if self.expert_axis:
                    full = shard_tensor(full, 2,
                                        mesh.axis_index(self.expert_axis),
                                        mesh.axis_size(self.expert_axis))
                w.copy_(full)

    def _publish(self, aux):
        # only where autograd records (a train step): a no-grad forward,
        # as serving and export run, keeps no tensor on the module
        self.aux_loss = aux if torch.is_grad_enabled() else None

    def capacity(self, n_tokens: int) -> int:
        """Token slots per expert for a group of ``n_tokens``."""
        return max(1, int(math.ceil(
            self.top_k * n_tokens * self.capacity_factor / self.n_experts)))

    def _routing(self, xt, router):
        """(g, n, d) tokens -> ([(expert, slot, weight)] per choice, each
        (g, n): the slot is the token's place in its expert's queue, the
        weight its combine weight whatever the capacity; the top-1
        fractions and mean gates (E,))."""
        e = self.n_experts
        logits = torch.einsum("gnd,ed->gne", xt.float(), router.float())
        gates = torch.softmax(logits, dim=-1)
        idx1 = gates.argmax(dim=-1)
        mask1 = F.one_hot(idx1, e)
        gate1 = gates.gather(-1, idx1[..., None])[..., 0]
        frac = mask1.float().mean(dim=(0, 1))
        prob = gates.mean(dim=(0, 1))
        # queue places by an integer cumsum over the group's tokens
        slot1 = (mask1.cumsum(dim=1) - mask1).gather(
            -1, idx1[..., None])[..., 0]
        if self.top_k == 1:
            return [(idx1, slot1, gate1)], frac, prob
        idx2 = torch.where(mask1 > 0, float("-inf"), logits).argmax(-1)
        mask2 = F.one_hot(idx2, e)
        gate2 = gates.gather(-1, idx2[..., None])[..., 0]
        # top-2 slots queue behind every top-1 slot of the group
        count1 = mask1.sum(dim=1, keepdim=True)
        slot2 = (mask2.cumsum(dim=1) - mask2 + count1).gather(
            -1, idx2[..., None])[..., 0]
        denom = gate1 + gate2 + 1e-9
        return ([(idx1, slot1, gate1 / denom), (idx2, slot2, gate2 / denom)],
                frac, prob)

    def _slots(self, choices, g, n, cap, e_first, e_count):
        """Per choice the flat row of each token in the (e_count * g *
        cap) slot rows of experts e_first.., or, where the token is not
        kept there (its slot is past ``cap``, or its expert another
        rank's), a row of its own past them; and whether it is kept."""
        rows = e_count * g * cap
        device = choices[0][0].device
        gi = torch.arange(g, device=device).view(g, 1)
        tok = torch.arange(g * n, device=device).view(g, n)
        out = []
        for c, (idx, slot, _) in enumerate(choices):
            local = idx - e_first
            kept = (slot < cap) & (local >= 0) & (local < e_count)
            flat = (local * g + gi) * cap + slot
            out.append((torch.where(kept, flat, rows + c * g * n + tok),
                        kept))
        return rows, out

    def _experts(self, xin, w1=None, w2=None):
        """(E_local, G, cap, d) slot inputs -> slot outputs: each local
        expert's SiLU MLP in the inputs' dtype (``w1``, ``w2``: banks of
        those experts, default the module's)."""
        e, gg, cap, d = xin.shape
        w1 = (self.w1 if w1 is None else w1).to(xin.dtype).permute(2, 1, 0)
        w2 = (self.w2 if w2 is None else w2).to(xin.dtype).permute(2, 1, 0)
        h = act.silu(torch.matmul(xin.reshape(e, gg * cap, d), w1))
        h = self.drop1(h)
        return torch.matmul(h, w2).reshape(e, gg, cap, d)

    def _dispatch(self, xt, choices, cap, e_first, e_count):
        """The kept tokens written into the (e_count, g, cap, d) slots of
        experts e_first.., and where each choice's token went."""
        g, n, d = xt.shape
        rows, where = self._slots(choices, g, n, cap, e_first, e_count)
        index = torch.cat([flat.reshape(-1) for flat, _ in where])
        values = xt.reshape(g * n, d).repeat(len(choices), 1)
        slots = xt.new_zeros(rows + len(choices) * g * n, d).index_put(
            (index,), values)
        return slots[:rows].view(e_count, g, cap, d), where

    @staticmethod
    def _combine(yo, choices, where, dtype):
        """Each token's kept slot outputs of ``yo`` (e_count, g, cap, d)
        summed with its choices' weights, in f32, as (g, n, d)."""
        d = yo.shape[-1]
        yo = yo.reshape(-1, d)
        out = None
        for (idx, _, w), (flat, kept) in zip(choices, where):
            y = yo[torch.where(kept, flat, 0).reshape(-1)].view(
                *idx.shape, d)
            term = (w * kept)[..., None] * y.float()
            out = term if out is None else out + term
        return out.to(dtype)

    def forward(self, x):
        axis = self.expert_axis
        *lead, n, d = x.shape
        if axis is not None and self.dispatch == "tokens":
            size = mesh.axis_size(axis)
            if n % size == 0:
                return self._forward_tokens(x, axis, size)
            warnings.warn(
                f"moe_dispatch='tokens' requested but {n} tokens do not "
                f"divide the {size}-way '{axis}' axis: falling back to "
                "replicated dispatch (exact, but per-rank activation/"
                "routing cost does not scale 1/EP)", stacklevel=2)
        router = self.router
        if axis is not None:
            x = tp_copy_in(x, axis)
            router = tp_copy_in(router, axis)
        g = math.prod(lead) if lead else 1
        xt = x.reshape(g, n, d)
        cap = self.capacity(n)
        choices, frac, prob = self._routing(xt, router)
        aux = self.n_experts * (frac * prob).sum()
        e_first, e_count = 0, self.n_experts
        if axis is not None:
            size = mesh.axis_size(axis)
            # each rank's whole aux gradient enters f's sums over the
            # axis: 1/size of it per rank, the value whole
            aux = aux / size + (aux * (1.0 - 1.0 / size)).detach()
            e_count = self.n_experts // size
            e_first = mesh.axis_index(axis) * e_count
        self._publish(aux)
        xin, where = self._dispatch(xt, choices, cap, e_first, e_count)
        out = self._combine(self._experts(xin), choices, where, xt.dtype)
        if axis is not None:
            out = tp_reduce_out(out, axis)
        return self.drop2(out).reshape(*lead, n, d)

    def _forward_tokens(self, x, axis, size):
        """dispatch='tokens' (module docstring)."""
        stream = contextlib.nullcontext()
        g0 = current_dropout_rng()
        if self.training and self.dropout > 0 and g0 is not None:
            stream = keyed_stream(g0, mesh.axis_index(axis))
        router = tp_copy_in(self.router, axis)
        with stream:
            xs = sp_scatter_tokens(x, axis)
            *lead, n_loc, d = xs.shape
            g = math.prod(lead) if lead else 1
            xt = xs.reshape(g, n_loc, d)
            cap = self.capacity(n_loc)
            choices, frac, prob = self._routing(xt, router)
            e = self.n_experts
            stats = torch.cat([frac, prob]).detach()
            mesh.all_reduce_sum_(stats, axis)
            frac_g, prob_g = (stats / size).split(e)
            self._publish(e * (frac_g * prob_g).sum()
                          + (e / size) * (frac_g
                                          * (prob - prob.detach())).sum())
            # (E, g, cap, d) -> (E/size, size*g, cap, d) and back
            xin, where = self._dispatch(xt, choices, cap, 0, e)
            yo = _AllToAll.apply(
                self._experts(_AllToAll.apply(xin, axis, 0, 1)), axis, 1, 0)
            out = self._combine(yo, choices, where, xt.dtype)
            out = self.drop2(out).reshape(*lead, n_loc, d)
        return sp_gather_tokens(out, axis)

