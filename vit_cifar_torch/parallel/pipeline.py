"""GPipe over a ``pipe`` mesh axis for the ViT trunk, as
``vit_cifar_tpu/parallel/pipeline.py``.

The encoder stack is cut into S contiguous stages of L/S blocks, stage s on
the ranks at place s of the ``pipe`` axis, and M microbatches stream through
them in JAX's tick loop (``_gpipe_blocks``): M + S - 1 ticks; at tick t
stage 0 takes microbatch t, every stage runs its blocks on the microbatch it
holds, the last stage banks its result, and a neighbour shift over the axis
(``Axis.shift``, JAX's ``ppermute`` i -> i + 1) hands each result to the
next stage.  The banked outputs are summed over the axis with
``reduce_from`` (sum forward, pass-through backward: the transpose
``shard_map`` gives JAX's ``psum``), so the head runs on the same value on
every rank.  The parameters stay whole on every rank (JAX keeps them
replicated over ``pipe`` and splits the stacked blocks only inside the
call), so the checkpoint keeps the one-device layout; the ``model`` axis's
Megatron layout composes inside each stage.

One process per rank, each with its own autograd, so the schedule's
backward is written out (``_GPipe``): in the backward each stage runs its
ticks in reverse, the inverse shift handing each input's cotangent back to
the stage before.  No rank's loss depends on an earlier stage's blocks
through its own graph, which is why the shift is not an autograd Function
of its own: its backward would never be reached on those ranks.  A stage
runs its blocks only on the ticks where it holds a microbatch (JAX's SPMD
loop runs every tick and drops the bubble's results), and the shifts run on
every tick, in the same order on every rank.

Each stage's blocks, the embedding (stage 0) and the head come out of the
backward once: a stage's gradient of another stage's blocks is zero, only
stage 0 passes a cotangent to the embedding, and the head's, which every
rank computes whole, is counted on the axis's first rank before the train
step sums the flat gradient over the axis (``mesh.trunk_split``).

The hot call only pipelines: a model with state (BatchNorm statistics, the
EMA bases of ``--train-md-bases``) or AE intermediates trains on the whole
trunk on every rank, as JAX sends its ``mutable`` apply to the sequential
module; evaluation is pipelined for every model.
"""

from __future__ import annotations

import torch

from ..models.vit import ViT
from .collectives import Axis, reduce_from
from .mesh import Mesh


def has_pipe_axis(mesh: Mesh | None) -> bool:
    return mesh is not None and mesh.shape.get("pipe", 1) > 1


class Pipeline:
    """How a ViT runs its encoder stack over a ``pipe`` axis (``ViT.
    pipeline``): ``mesh`` (None: one stage), ``microbatches`` M, and
    ``sequential_training``: the training call runs the whole trunk on
    every rank instead."""

    def __init__(self, mesh: Mesh | None, microbatches: int,
                 sequential_training: bool = False):
        self.mesh, self.microbatches = mesh, microbatches
        self.axis = None if mesh is None else mesh.axis("pipe")
        self.sequential_training = sequential_training

    def takes(self, deterministic: bool) -> bool:
        """Whether the call is pipelined: evaluation always, training
        unless ``sequential_training``."""
        return deterministic or not self.sequential_training

    def run(self, vit: ViT, h: torch.Tensor,
            deterministic: bool) -> torch.Tensor:
        """The encoder stack on the stream ``h`` leaving ``vit.embed``."""
        return _gpipe_blocks(vit, self.mesh, self.microbatches, h,
                             deterministic)


def pipeline_model(vit: ViT, mesh: Mesh | None, microbatches: int = 0) -> ViT:
    """JAX's ``PipelineViT``: set ``vit``'s pipeline over ``mesh``'s
    ``pipe`` axis (``microbatches`` 0: one a stage), in place, and return
    it.  Raises JAX's ValueErrors for what the pipeline cannot run."""
    if not isinstance(vit, ViT):
        raise ValueError(
            "pipeline parallelism covers the ViT trunk "
            f"(models/vit.ViT); got {type(vit).__name__}. CNN models "
            "have no layer stack to cut into stages — run them on a "
            "data-only mesh.")
    if vit.dropout != 0.0:
        raise ValueError(
            "pipeline parallelism requires dropout=0 (per-stage rng "
            "folding for stochastic layers is not implemented; the "
            "README recipe uses dropout 0).")
    if vit.mlp_factory is not None:
        raise ValueError(
            "pipeline parallelism does not compose with the MoE "
            "mlp_factory: the staged block rebuild would drop the sown "
            "Switch balance loss silently. Scale MoE over an 'expert' "
            "mesh axis instead (parallel/mesh._ep_spec).")
    # mixers that draw random state every call (the burgers' rand_init MD
    # bases, the AE's random masks): JAX's staged apply does not thread
    # its 'mask' rng, so it refuses them, and so does the port
    if any(getattr(m, "rand_init", False)
           or getattr(m, "mask_type", None) == "random"
           for m in vit.modules()):
        name = type(vit.enc0.mixer).__name__
        raise ValueError(
            f"pipeline parallelism does not support the {name} "
            "mixer with per-step random state (rand_init MD bases / "
            "random AE masks): the pipelined apply does not thread the "
            "'mask' rng, so the mixer would silently reuse a fixed key "
            "every step. Use --train-md-bases (persistent EMA bases) or "
            "run this model on a data-only mesh.")
    if not has_pipe_axis(mesh):
        raise ValueError("mesh has no 'pipe' axis > 1")
    stages = mesh.shape["pipe"]
    if vit.num_layers % stages != 0:
        raise ValueError(
            f"num_layers={vit.num_layers} must divide evenly into "
            f"{stages} pipeline stages")
    stateful = any(True for _ in vit.buffers()) or any(
        hasattr(m, "ae_input") for m in vit.modules())
    vit.pipeline = Pipeline(mesh, microbatches or stages, stateful)
    return vit


def pipeline_forward(vit: ViT, mesh: Mesh | None, microbatches: int,
                     x: torch.Tensor, deterministic: bool = True):
    """The ViT forward with the encoder stack run GPipe-style over
    ``mesh``'s ``pipe`` axis, or at one stage with ``mesh`` None (M
    microbatches through the same tick loop).  Per example the math is
    ``ViT.forward``'s."""
    h = _gpipe_blocks(vit, mesh, microbatches, vit.embed(x), deterministic)
    return vit.head(h)


def _gpipe_blocks(vit: ViT, mesh: Mesh | None, M: int, h: torch.Tensor,
                  deterministic: bool) -> torch.Tensor:
    """The stacked encoder blocks over the ``pipe`` axis: this rank's
    stream ``h`` (its data shard's rows) in, the last stage's output on
    every rank out."""
    for ax, size in ({} if mesh is None else mesh.shape).items():
        if ax not in ("data", "pipe", "model") and size > 1:
            raise ValueError(
                f"pipeline_forward supports (data, pipe[, model]) meshes; "
                f"axis '{ax}' has size {size}")
    axis = None if mesh is None else mesh.axis("pipe")
    S = 1 if axis is None else axis.size
    if h.shape[0] % M != 0:
        raise ValueError(f"per-data-shard batch {h.shape[0]} must divide "
                         f"into {M} microbatches")
    per_stage = vit.num_layers // S
    stage = 0 if axis is None else axis.rank
    ticks = _Ticks(vit, axis, M, range(stage * per_stage,
                                       (stage + 1) * per_stage),
                   deterministic)
    if torch.is_grad_enabled():
        params = [p for i in ticks.layers
                  for p in getattr(vit, f"enc{i}").parameters()
                  if p.requires_grad]
        out = _GPipe.apply(ticks, h, *params)
    else:
        out = ticks.forward(h, keep=False)
    return out if axis is None else reduce_from(out, axis)


class _Ticks:
    """One stage's side of the tick loop: ``forward`` runs it (keeping
    each tick's graph for ``backward`` when asked), ``backward`` runs it in
    reverse."""

    def __init__(self, vit: ViT, axis: Axis | None, M: int, layers,
                 deterministic: bool):
        self.vit, self.axis, self.M = vit, axis, M
        self.layers, self.deterministic = layers, deterministic
        self.S = 1 if axis is None else axis.size
        self.stage = 0 if axis is None else axis.rank
        self.n_ticks = M + self.S - 1
        self.graphs: list[tuple[torch.Tensor, torch.Tensor]] = []

    def microbatch(self, t: int) -> int | None:
        """The microbatch this stage holds at tick ``t``, or None."""
        m = t - self.stage
        return m if 0 <= m < self.M else None

    def _shift(self, x: torch.Tensor, offset: int) -> torch.Tensor:
        return x if self.axis is None else self.axis.shift(x, offset)

    def forward(self, h: torch.Tensor, keep: bool) -> torch.Tensor:
        """The banked microbatches on the last stage, zeros elsewhere;
        with ``keep`` each tick's (input, output) graph is kept."""
        feeds = h.chunk(self.M)
        zeros = torch.zeros_like(feeds[0])
        arriving, bank = zeros, []
        for t in range(self.n_ticks):
            m = self.microbatch(t)
            cur = zeros
            if m is not None:
                inp = feeds[m] if self.stage == 0 else arriving
                if keep:
                    inp = inp.detach().requires_grad_()
                cur = self.vit.blocks(inp, self.layers, self.deterministic)
                if keep:
                    self.graphs.append((inp, cur))
                if self.stage == self.S - 1:
                    bank.append(cur.detach())
            if t < self.n_ticks - 1:
                arriving = self._shift(cur.detach(), 1)
        if self.stage == self.S - 1:
            return torch.cat(bank)
        return torch.zeros_like(h)

    def backward(self, g: torch.Tensor, params: list[torch.Tensor]):
        """(the cotangent of ``h``, of each of ``params``) from the
        cotangent ``g`` of the forward's output."""
        g_bank = g.chunk(self.M)
        zeros = torch.zeros_like(g_bank[0])
        g_feeds: list[torch.Tensor | None] = [None] * self.M
        g_params: list[torch.Tensor | None] = [None] * len(params)
        g_recv = zeros  # this tick's output's cotangent, from the next stage
        for t in reversed(range(self.n_ticks)):
            m = self.microbatch(t)
            g_inp = zeros
            if m is not None:
                inp, cur = self.graphs.pop()
                g_cur = g_bank[m] if self.stage == self.S - 1 else g_recv
                grads = torch.autograd.grad(cur, [inp, *params], g_cur,
                                            allow_unused=True)
                for i, gp in enumerate(grads[1:]):
                    if gp is not None:
                        g_params[i] = gp if g_params[i] is None \
                            else g_params[i] + gp
                if self.stage == 0:
                    g_feeds[m] = grads[0]
                else:
                    g_inp = grads[0]
            if t > 0:  # the inverse of tick t - 1's shift
                g_recv = self._shift(g_inp, -1)
        g_h = torch.cat(g_feeds) if self.stage == 0 else None
        return g_h, g_params


class _GPipe(torch.autograd.Function):
    """The tick loop as one node of this rank's graph: its inputs are the
    stream and this stage's parameters, and its backward is the tick loop
    in reverse, so that every rank runs the inverse shifts in the same
    order."""

    @staticmethod
    def forward(ctx, ticks: _Ticks, h: torch.Tensor, *params):
        with torch.enable_grad():
            out = ticks.forward(h, keep=True)
        ctx.ticks, ctx.params = ticks, params  # leaves: no copy is kept
        return out

    @staticmethod
    def backward(ctx, g):
        g_h, g_params = ctx.ticks.backward(g, list(ctx.params))
        del ctx.ticks, ctx.params
        return (None, g_h, *g_params)
