"""The collectives of the mesh axes, one process per device.

``Axis`` is one mesh axis as this rank sees it: its process group, this
rank's place on it and its size.  Tensor and expert parallelism use
Megatron's pair of operators, as ``torch.autograd.Function``s:

  * ``copy_to`` (Megatron's *f*) on the input of a column-parallel layer:
    the identity forward, the gradient summed over the axis backward;
  * ``reduce_from`` (*g*) after a row-parallel layer: the partial outputs
    summed over the axis forward, the identity backward;

and the two that move a tensor between its column shards and the whole:

  * ``gather_from``: the shards concatenated along a dim forward, this
    rank's block of the gradient backward;
  * ``scatter_to``: this rank's block forward, the gradient's blocks
    gathered backward.

A rank's gradient of a replicated tensor is whole where the backward of
every path out of it is whole; these four keep it so.  Batch statistics
over the ``data`` axis are sums taken with ``summed`` (differentiable:
its backward sums the gradients over the axis, which the train step's mean
over data ranks then turns into the global gradient) or ``global_amax``.

Where an axis splits the work of one example (``seq`` its tokens, ``pipe``
its layers), a rank's gradient is its part, and the train step sums it over
the axis.  Two pieces serve that split:

  * ``reduce_from`` is also the transpose that JAX's ``shard_map`` gives a
    ``psum`` onto an axis-invariant output (the pipe's banked outputs, the
    pooled row of a cut stream): every rank then runs the head on the same
    value, and the head's cotangent reaches each rank's part once;
  * ``gather_summed``: the blocks gathered forward, this rank's block of
    the cotangent summed over the axis backward (the reduce-scatter that
    GSPMD places after attention's key/value gathers).

``Axis.shift`` is JAX's ``lax.ppermute`` over the ring i -> i + offset;
``parallel/pipeline.py`` runs it forward and its inverse backward.

``local_draw`` is the global-draw rule: a random tensor is drawn at the
shape it has on one device, from the same generator state on every rank,
and each rank keeps its block, so a sharded run draws what the one-process
run draws.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dist_fn


@dataclass(frozen=True)
class Axis:
    """One mesh axis from this rank: ``group`` spans the ranks that differ
    from this one only in their place on the axis."""

    name: str
    group: dist.ProcessGroup
    rank: int
    size: int

    def block(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's block of ``x`` along ``dim`` (a view)."""
        n = x.shape[dim]
        if n % self.size:
            raise ValueError(f"{n} along dim {dim} does not divide over "
                             f"the {self.size} ranks of axis {self.name!r}")
        step = n // self.size
        return x.narrow(dim, self.rank * step, step)

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The blocks of every rank, concatenated along ``dim`` in rank
        order."""
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x.contiguous(), group=self.group)
        return torch.cat(parts, dim=dim)

    def all_reduce_(self, x: torch.Tensor,
                    op=dist.ReduceOp.SUM) -> torch.Tensor:
        """``x`` reduced over the axis in place (no gradient)."""
        dist.all_reduce(x, op=op, group=self.group)
        return x

    def shift(self, x: torch.Tensor, offset: int = 1) -> torch.Tensor:
        """Every rank sends ``x`` to the rank ``offset`` places on along
        the ring and returns what the rank ``offset`` places back sent (no
        gradient).  The send and the receive are posted together, so a
        ring of them cannot deadlock on gloo or NCCL."""
        if self.size == 1:
            return x
        out = torch.empty_like(x)

        def peer(k: int) -> int:
            return dist.get_global_rank(self.group, k % self.size)

        ops = [dist.P2POp(dist.isend, x.contiguous(),
                          peer(self.rank + offset), self.group),
               dist.P2POp(dist.irecv, out, peer(self.rank - offset),
                          self.group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return out


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.all_reduce_(g.clone()), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return axis.all_reduce_(x.clone())

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return axis.all_gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.block(g, ctx.dim).contiguous(), None, None


class _ScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return axis.block(x, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.all_gather(g, ctx.dim), None, None


def copy_to(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Megatron's *f*: the identity forward, the gradient summed over
    ``axis`` backward."""
    return _CopyTo.apply(x, axis)


def reduce_from(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Megatron's *g*: ``x`` summed over ``axis`` forward, the identity
    backward."""
    return _ReduceFrom.apply(x, axis)


def gather_from(x: torch.Tensor, axis: Axis, dim: int = -1) -> torch.Tensor:
    """The whole of a tensor cut over ``axis`` along ``dim``; backward,
    this rank's block of the gradient."""
    return _GatherFrom.apply(x, axis, dim % x.dim())


def scatter_to(x: torch.Tensor, axis: Axis, dim: int = -1) -> torch.Tensor:
    """This rank's block of a replicated ``x`` along ``dim``; backward, the
    whole gradient, gathered from every rank's block."""
    return _ScatterTo.apply(x, axis, dim % x.dim())


def gather_summed(x: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    """The blocks of every rank of ``axis`` concatenated along ``dim``;
    backward, this rank's block of the cotangent summed over the axis,
    for a gathered tensor each rank reads its own part of."""
    return copy_to(gather_from(x, axis, dim), axis)


def summed(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """``x`` summed over ``axis``, differentiably: the backward sums the
    gradients over the axis too."""
    return dist_fn.all_reduce(x, group=axis.group)


class _GlobalAmax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis):
        m = axis.all_reduce_(x.amax(dim, keepdim=True), dist.ReduceOp.MAX)
        hit = x == m
        ctx.save_for_backward(hit)
        ctx.dim, ctx.axis = dim, axis
        return m

    @staticmethod
    def backward(ctx, g):
        (hit,) = ctx.saved_tensors
        # every rank's loss reads the max: its gradient is the sum of
        # theirs, shared evenly among the elements that equal it, on
        # whichever rank they lie (torch's amax shares it the same way)
        g = ctx.axis.all_reduce_(g.clone())
        ties = ctx.axis.all_reduce_(hit.sum(ctx.dim, keepdim=True).to(g.dtype))
        return torch.where(hit, g / ties, torch.zeros((), dtype=g.dtype,
                                                      device=g.device)), \
            None, None


def global_amax(x: torch.Tensor, dim: int, axis: Axis) -> torch.Tensor:
    """``x.amax(dim, keepdim=True)`` over the blocks of every rank of
    ``axis`` along ``dim``."""
    return _GlobalAmax.apply(x, dim, axis)


Shards = tuple[tuple[int, "Axis | None"], ...]


def local_draw(draw: Callable[[tuple], torch.Tensor], shape,
               shards: Shards = ()) -> torch.Tensor:
    """``draw(global_shape)`` cut to this rank's block: ``shape`` is the
    local shape, and each (dim, axis) of ``shards`` (axis None: not cut)
    multiplies that dim by the axis size for the draw and keeps this rank's
    block of it."""
    shards = tuple((d % len(shape), a) for d, a in shards if a is not None)
    full = list(shape)
    for d, a in shards:
        full[d] *= a.size
    out = draw(tuple(full))
    for d, a in shards:
        out = a.block(out, d)
    return out
