"""The Mixture-of-Experts MLP with Switch top-1 routing, as
``vit_cifar_tpu/ops/moe.py`` (no reference counterpart: it takes the
place of the encoder MLP under ``--moe-experts``).

The einsum form of GShard/Switch: routing is two one-hot (B, T, E, C)
tensors, dispatch and combine, and the experts are stacked parameters
``expert_w1`` (E, F, H), ``expert_b1`` (E, H), ``expert_w2`` (E, H, F) and
``expert_b2`` (E, F), under JAX's names and layouts.  Tokens are grouped
per example: each expert takes C = min(T, max(1, ceil(T/E * cf))) tokens
of an example, first come first served in token order, and an overflow
token comes out as zero (the block's residual carries it).  Each expert
runs Linear -> GELU -> Dropout -> Linear -> GELU -> Dropout, the encoder
MLP's trailing GELU included.  The router is a Linear in f32.

The Switch load-balance loss, E * sum_e f_e * P_e (1.0 at perfect
balance), taken before any token is dropped, is kept on the module as
``aux`` by each forward; the train step reads it right after its forward
(``collect_moe_aux``), so a ``--remat`` recomputation in the backward
never supplies it.

Under a data axis the Switch statistics f_e and P_e of a training forward
are global means (P_e through a differentiable sum): the aux term is a
product of means, which an average of per-rank values would not give.
Capacity stays per example, so routing does not depend on the data axis.
Under an expert axis each rank keeps ``E / n_expert`` of the stacked
weights and runs its experts on the tokens dispatched to them; the combine
is summed over the expert group.  The router, the aux term and the routing
run whole on every rank; the experts' part reads the layer's input and the
combine weights through ``copy_to``, so the router and the input get their
full gradient, summed over the experts, on every rank.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.collectives import Axis, copy_to, reduce_from, summed
from .common import dropout
from .init import Linear, uniform_range


class MoEMLP(nn.Module):
    EP_PARAMS = ("expert_w1", "expert_b1", "expert_w2", "expert_b2")
    data_axis: Axis | None = None
    ep_axis: Axis | None = None
    seq_axis: Axis | None = None

    def __init__(self, features: int, mlp_hidden: int, num_experts: int = 8,
                 capacity_factor: float = 1.25, dropout: float = 0.0, *,
                 generator: torch.Generator,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        E, Fe, H = num_experts, features, mlp_hidden
        self.num_experts, self.capacity_factor = E, capacity_factor
        self.rate, self.dtype = dropout, dtype
        # routing decisions in f32, so they do not dither with bf16
        self.router = Linear(Fe, E, generator=generator,
                             dtype=torch.float32, device=device)
        b1, b2 = 1.0 / Fe ** 0.5, 1.0 / H ** 0.5
        for name, shape, b in (("expert_w1", (E, Fe, H), b1),
                               ("expert_b1", (E, H), b1),
                               ("expert_w2", (E, H, Fe), b2),
                               ("expert_b2", (E, Fe), b2)):
            self.register_parameter(name, nn.Parameter(
                uniform_range(shape, -b, b, generator).to(device)))
        self.aux: torch.Tensor | None = None

    def forward(self, x: torch.Tensor, *, deterministic: bool = True,
                generator: torch.Generator | None = None) -> torch.Tensor:
        B, T, _ = x.shape
        E, dt, sp = self.num_experts, self.dtype, self.seq_axis
        T_all = T if sp is None else T * sp.size
        C = min(T_all, max(1, math.ceil(T_all / E * self.capacity_factor)))
        probs = torch.softmax(self.router(x.to(torch.float32)), dim=-1)
        gate, expert = probs.max(dim=-1)  # (B, T): the top-1 prob and index
        onehot = F.one_hot(expert, E).to(torch.float32)  # (B, T, E)
        # each token's 1-based place in its expert's buffer, 0 elsewhere
        pos = torch.cumsum(onehot, dim=1)
        if sp is not None:  # after the tokens of the ranks before this one
            counts = sp.all_gather(pos[:, -1:], 1)  # (B, n_seq, E)
            pos = pos + counts[:, :sp.rank].sum(dim=1, keepdim=True)
        pos = pos * onehot
        keep = (pos <= C) * onehot
        # place 0 (not this expert) and places past C give all-zero rows
        slot = (pos.long()[..., None] - 1 == torch.arange(
            C, device=x.device)).to(torch.float32)  # (B, T, E, C)
        dispatch = slot * keep[..., None]
        combine = dispatch * gate[..., None, None]
        # the fraction routed to each expert before the drop, and its mean
        # router probability, over the global batch in training
        routed, prob = onehot.sum(dim=(0, 1)), probs.sum(dim=(0, 1))
        n = B * T_all
        data, ep = self.data_axis, self.ep_axis
        if sp is not None and not deterministic:
            routed, prob = sp.all_reduce_(routed), reduce_from(prob, sp)
        if data is not None and not deterministic:
            routed = data.all_reduce_(routed)
            prob, n = summed(prob, data), n * data.size
        self.aux = E * torch.sum(routed / n * (prob / n))

        if ep is not None:  # this rank's experts
            lo, El = ep.rank * (E // ep.size), E // ep.size
            x = copy_to(x, ep)
            combine = copy_to(combine, ep)[:, :, lo:lo + El]
            dispatch = dispatch[:, :, lo:lo + El]
        shards = ((0, ep), (1, data))
        xin = torch.einsum("btec,btf->ebcf", dispatch.to(dt), x.to(dt))
        h = torch.einsum("ebcf,efh->ebch", xin, self.expert_w1.to(dt)) \
            + self.expert_b1.to(dt)[:, None, None, :]
        h = dropout(F.gelu(h), self.rate, deterministic, generator, shards)
        h = torch.einsum("ebch,ehf->ebcf", h, self.expert_w2.to(dt)) \
            + self.expert_b2.to(dt)[:, None, None, :]
        h = dropout(F.gelu(h), self.rate, deterministic, generator, shards)
        out = torch.einsum("btec,ebcf->btf", combine.to(dt), h)
        return out if ep is None else reduce_from(out, ep)


def collect_moe_aux(model: nn.Module) -> torch.Tensor | None:
    """The mean over the MoE layers of the aux loss their last forward
    kept, or None where the model has none."""
    vals = [m.aux for m in model.modules() if isinstance(m, MoEMLP)]
    return sum(vals) / len(vals) if vals else None
