"""The device mesh and the weight layout, as ``vit_cifar_tpu/parallel/mesh.py``,
over ``torch.distributed`` with one process per device.

The JAX package runs one process over many devices and lets GSPMD place
the collectives from the shardings.  Here each device has its own process
(``torchrun --nproc-per-node N``), the mesh is
``torch.distributed.device_mesh.init_device_mesh`` with one process group
per axis, and the collectives are written where the math needs them
(``parallel/collectives.py``):

  * ``data``: every rank builds the global batch and keeps its rows; the
    train step takes one mean of the flat gradient over the axis (GSPMD's
    psum), BatchNorm and the MoE's Switch statistics are global sums, and
    every random draw is made at the global shape;
  * ``model``: the Megatron layout of ``_tp_spec`` -- Wq/Wk/Wv, fc1 and U
    column-parallel, out_project, fc2 and V row-parallel -- which the
    modules that own those weights compute with (their ``TP_LAYOUT``);
  * ``expert``: the MoE's stacked ``expert_*`` weights cut on their leading
    E dim (``_ep_spec``);
  * ``pipe``: GPipe stages of the ViT's encoder stack
    (``parallel/pipeline.py``);
  * ``seq``: the ViT's token stream cut over the axis
    (``parallel/sequence.py``).

As in JAX, the parameters are cut over ``model`` and ``expert`` only: they
stay whole over ``data``, ``pipe`` and ``seq``, and the checkpoint keeps
the one-device layout, so a run resumes on any mesh.  Under ``pipe`` and
``seq`` a rank's gradient is its part of each example's (its stage's
blocks, its tokens): ``trunk_split`` says how the train step sums it.

The backend follows the device: NCCL for ``cuda``, gloo for ``cpu``.
"""

from __future__ import annotations

import contextlib
import math
import os
from dataclasses import dataclass

import torch
import torch.distributed as dist
from torch import nn

from ..utils.transplant import flax_layout
from .collectives import Axis

TORCHRUN = ("start one process per device with torchrun: torchrun "
            "--nproc-per-node N -m vit_cifar_torch --mesh-shape ... "
            "--mesh-axes ...")


def backend_for(device) -> str:
    """The process group's backend for ``device``: NCCL for a CUDA device,
    gloo for the CPU.  Neither stands in for the other."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize_multihost(coordinator_address: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None, *, device="cuda",
                         **extra) -> dict:
    """Join the process group of a multi-process run, the counterpart of
    ``jax.distributed.initialize``.

    The cluster is ``coordinator_address`` ("host:port"), ``num_processes``
    and ``process_id``, or torchrun's ``MASTER_ADDR``/``MASTER_PORT``,
    ``WORLD_SIZE`` and ``RANK``; ``extra`` goes to
    ``torch.distributed.init_process_group`` (e.g. ``timeout``).  As in
    JAX: a cluster that is described and cannot be joined raises; with no
    cluster described at all it prints a warning and the run is one
    process; an already joined group is kept.  Returns the topology."""
    if not dist.is_initialized():
        env = os.environ
        addr = coordinator_address or (
            f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
            if "MASTER_ADDR" in env else None)
        nproc = num_processes or env.get("WORLD_SIZE")
        pid = process_id if process_id is not None else env.get("RANK")
        if addr is None and nproc is None and pid is None:
            print("[vit_cifar_torch] WARNING: no cluster described (no "
                  "coordinator address, MASTER_ADDR, WORLD_SIZE or RANK); "
                  "continuing as a SINGLE process. If this is a "
                  "multi-process run, launch it with torchrun or pass the "
                  "coordinator address, the number of processes and this "
                  "process's id.")
        else:
            if addr is None or nproc is None or pid is None:
                raise ValueError(
                    f"a cluster described in part (coordinator {addr}, "
                    f"processes {nproc}, process id {pid}): give all three")
            dist.init_process_group(backend_for(device),
                                    init_method=f"tcp://{addr}",
                                    world_size=int(nproc), rank=int(pid),
                                    **extra)
    n = dist.get_world_size() if dist.is_initialized() else 1
    return {"process_index": dist.get_rank() if dist.is_initialized() else 0,
            "process_count": n, "local_device_count": 1,
            "global_device_count": n}


class Mesh:
    """The named device mesh of this process: ``shape`` maps each axis to
    its size, ``axis(name)`` gives this rank's ``Axis`` on it (None where
    the mesh has no such axis), ``world`` spans every rank."""

    def __init__(self, device_mesh):
        self.device_mesh = device_mesh
        names = device_mesh.mesh_dim_names
        self.shape = dict(zip(names, device_mesh.shape))
        self._axes = {n: Axis(n, device_mesh.get_group(n),
                              device_mesh.get_local_rank(n), self.shape[n])
                      for n in names}
        self.world = Axis("world", dist.group.WORLD, dist.get_rank(),
                          dist.get_world_size())
        self.rank = dist.get_rank()

    def axis(self, name: str) -> Axis | None:
        return self._axes.get(name)


def make_mesh(mesh_shape=(), mesh_axes=("data",), device="cuda") -> Mesh | None:
    """The mesh of ``mesh_shape`` over ``mesh_axes``, one rank per device;
    ``()`` puts every rank on the first axis (``data``).

    Outside a process group there is no mesh (None): a one-device shape is
    the one-process run, and a larger one raises, naming torchrun.  Unlike
    JAX, which keeps the first n devices of its one process, a shape whose
    product differs from the world size raises."""
    mesh_shape, mesh_axes = tuple(mesh_shape), tuple(mesh_axes)
    if not dist.is_initialized():
        if math.prod(mesh_shape or (1,)) > 1:
            raise ValueError(f"mesh {mesh_shape} over {mesh_axes} needs one "
                             f"process per device: {TORCHRUN}")
        return None
    want = backend_for(device)
    if dist.get_backend() != want:
        raise ValueError(f"the process group's backend is "
                         f"{dist.get_backend()}; a {torch.device(device).type}"
                         f" run takes {want}")
    world = dist.get_world_size()
    if not mesh_shape:
        mesh_shape = (world,) + (1,) * (len(mesh_axes) - 1)
    if len(mesh_shape) != len(mesh_axes):
        raise ValueError(f"mesh {mesh_shape} has {len(mesh_shape)} dims "
                         f"for the axes {mesh_axes}")
    if math.prod(mesh_shape) != world:
        raise ValueError(f"mesh {mesh_shape} holds {math.prod(mesh_shape)} "
                         f"devices and the run has {world} processes: "
                         f"{TORCHRUN}")
    from torch.distributed.device_mesh import init_device_mesh

    return Mesh(init_device_mesh(torch.device(device).type, mesh_shape,
                                 mesh_dim_names=mesh_axes))


def trunk_split(model: nn.Module) -> tuple[Axis, torch.Tensor] | None:
    """Where ``model``'s training forward splits each example's work over
    an axis (``seq``: its tokens; ``pipe``: its stages, where the training
    call is pipelined), that axis and a bool vector over the flat gradient
    with the loss and accuracy appended: False at the entries that every
    rank of the axis computes whole (the head, the loss, the accuracy) on
    all but its first rank.  Summing the vector over the axis with those
    entries zeroed counts each part of the gradient once.  None where the
    model splits nothing."""
    pipeline = getattr(model, "pipeline", None)
    axis = getattr(model, "seq_axis", None)
    if pipeline is not None and pipeline.takes(deterministic=False):
        axis = pipeline.axis
    if axis is None:
        return None
    first = axis.rank == 0
    keep = [torch.full((p.numel(),), first or name.split(".")[0] not in
                       ("fc_norm", "fc"), dtype=torch.bool, device=p.device)
            for name, p in model.named_parameters()]
    return axis, torch.cat(keep + [torch.full((2,), first, device=keep[0]
                                              .device)])


@contextlib.contextmanager
def one_device_forward(model: nn.Module):
    """Within the block, ``model``'s forward is the one-device model's on
    every rank: its ``pipe`` and ``seq`` hooks are lifted (a padded stream
    stays padded and masked), as JAX runs a capturing apply on the
    sequential module."""
    hooks = [(m, "seq_axis") for m in model.modules()
             if getattr(m, "seq_axis", None) is not None]
    if getattr(model, "pipeline", None) is not None:
        hooks.append((model, "pipeline"))
    saved = [getattr(m, k) for m, k in hooks]
    for m, k in hooks:
        setattr(m, k, None)
    try:
        yield model
    finally:
        for (m, k), v in zip(hooks, saved):
            setattr(m, k, v)


def has_model_axis(mesh: Mesh | None) -> bool:
    return mesh is not None and mesh.shape.get("model", 1) > 1


def has_expert_axis(mesh: Mesh | None) -> bool:
    return mesh is not None and mesh.shape.get("expert", 1) > 1


def _ep_spec(path_names: list[str], ndim: int) -> tuple:
    """Expert-parallel layout, in flax's names and layouts: the MoE's
    expert stacks (leading dim E) over ``expert``; everything else, the
    router included, whole."""
    if path_names[-1].startswith("expert_"):
        return ("expert",) + (None,) * (ndim - 1)
    return ()


def _tp_spec(path_names: list[str], ndim: int) -> tuple:
    """The Megatron layout of the trunk's Linears, in flax's names and
    layouts (a kernel is (in, out)): column-parallel (output features over
    ``model``) for Wq/Wk/Wv, fc1 and U; row-parallel (input features) for
    out_project, fc2 and V; everything else whole."""
    col = ("Wq", "Wk", "Wv", "fc1", "U")
    row = ("out_project", "fc2", "V")
    if any(c in path_names for c in col):
        if path_names[-1] == "kernel" and ndim == 2:
            return (None, "model")
        if path_names[-1] == "bias" and ndim == 1:
            return ("model",)
    if any(r in path_names for r in row):
        if path_names[-1] == "kernel" and ndim == 2:
            return ("model", None)
    return ()


@dataclass(frozen=True)
class Shard:
    """How a parameter is cut: over ``axis`` along its torch ``dim``;
    ``halves``: the dim holds two halves (a gMLP-style ``U`` whose output
    is chunked in two), each cut alike, so a rank holds the matching
    slices of both."""

    axis: str
    dim: int
    halves: bool = False

    def cut(self, full: torch.Tensor, axis: Axis) -> torch.Tensor:
        if not self.halves:
            return axis.block(full, self.dim)
        return torch.cat([axis.block(h, self.dim)
                          for h in full.chunk(2, self.dim)], self.dim)

    def join(self, parts: list[torch.Tensor]) -> torch.Tensor:
        if not self.halves:
            return torch.cat(parts, self.dim)
        halves = [p.chunk(2, self.dim) for p in parts]
        return torch.cat([h[0] for h in halves] + [h[1] for h in halves],
                         self.dim)


# a module's TP_LAYOUT names its Linear children and their kind
_KINDS = {"col": ((0, 0), False), "col_halves": ((0, 0), True),
          "row": ((1, None), False)}


def _class_plan(model: nn.Module) -> dict[str, Shard]:
    """The cut of every parameter that a module class computes with a
    shard of: its ``TP_LAYOUT`` (Linear children: weight and bias dims),
    and the MoE's expert stacks."""
    plan = {}
    for mname, m in model.named_modules():
        prefix = f"{mname}." if mname else ""
        for child, kind in getattr(type(m), "TP_LAYOUT", {}).items():
            if getattr(m, child, None) is None:
                continue
            (w_dim, b_dim), halves = _KINDS[kind]
            plan[f"{prefix}{child}.weight"] = Shard("model", w_dim, halves)
            if b_dim is not None:
                plan[f"{prefix}{child}.bias"] = Shard("model", b_dim, halves)
        for name in getattr(type(m), "EP_PARAMS", ()):
            plan[f"{prefix}{name}"] = Shard("expert", 0)
    return plan


def _table_plan(model: nn.Module, tp: bool, ep: bool) -> dict[str, tuple]:
    """The JAX name tables applied to the port's parameters: name ->
    (axis, torch dim)."""
    owners = dict(model.named_modules())
    out = {}
    for name, p in model.named_parameters():
        *mod, leaf = name.split(".")
        flax_leaf, perm = flax_layout(owners[".".join(mod)], leaf)
        names = mod + [flax_leaf]
        spec = _tp_spec(names, p.ndim) if tp else ()
        if ep and not spec:
            spec = _ep_spec(names, p.ndim)
        if spec:
            axis = next(s for s in spec if s is not None)
            dim = spec.index(axis)
            out[name] = (axis, perm.index(dim) if perm else dim)
    return out


class ParamLayout:
    """The cut of a sharded model's parameters, and the moves between this
    rank's flat vector (``optim.flatten_params``) and the one-device layout
    that checkpoints keep."""

    def __init__(self, mesh: Mesh, model: nn.Module,
                 shards: dict[str, Shard]):
        self.mesh, self.shards = mesh, shards
        self.entries = [(n, tuple(p.shape), shards.get(n))
                        for n, p in model.named_parameters()]

    def _axis(self, shard: Shard) -> Axis:
        return self.mesh.axis(shard.axis)

    def local(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's block of parameter ``name`` given its whole
        one-device value."""
        shard = self.shards.get(name)
        return full if shard is None else shard.cut(full, self._axis(shard))

    def full_named(self, local: dict[str, torch.Tensor]) -> dict:
        """Whole one-device values of the named local tensors (every rank
        takes part in the gathers)."""
        out = {}
        for name, t in local.items():
            shard = self.shards.get(name)
            if shard is None:
                out[name] = t
                continue
            ax = self._axis(shard)
            parts = [torch.empty_like(t) for _ in range(ax.size)]
            dist.all_gather(parts, t.contiguous(), group=ax.group)
            out[name] = shard.join(parts)
        return out

    def split_flat(self, flat: torch.Tensor) -> dict[str, torch.Tensor]:
        """Named views of a local flat vector, in ``flatten_params``
        order."""
        out, offset = {}, 0
        for name, shape, _ in self.entries:
            n = math.prod(shape)
            out[name] = flat[offset:offset + n].view(shape)
            offset += n
        return out

    def full_flat(self, flat: torch.Tensor) -> torch.Tensor:
        """The one-device flat vector of a local one (params or a moment)."""
        full = self.full_named(self.split_flat(flat))
        return torch.cat([full[n].reshape(-1) for n, _, _ in self.entries])

    def local_flat(self, full_flat: torch.Tensor) -> torch.Tensor:
        """This rank's flat vector of a one-device one."""
        parts, offset = [], 0
        for name, shape, shard in self.entries:
            if shard is not None:
                d, ax = shard.dim, self._axis(shard)
                shape = shape[:d] + (shape[d] * ax.size,) + shape[d + 1:]
            n = math.prod(shape)
            full = full_flat[offset:offset + n].view(shape)
            parts.append(self.local(name, full).reshape(-1))
            offset += n
        return torch.cat(parts)


def plan_layout(model: nn.Module, tp: bool, ep: bool) -> dict[str, Shard]:
    """The cut of ``model``'s parameters over a model axis (``tp``) and an
    expert axis (``ep``): name -> ``Shard``.

    The cut is chosen by module class (``TP_LAYOUT``, ``EP_PARAMS``) and
    must equal the one JAX's name tables give (``_tp_spec``,
    ``_ep_spec``).  As in JAX, a model axis over a model that nothing of
    the table matches raises, and so does an expert axis over a model with
    no expert stacks, instead of silently replicating."""
    table = _table_plan(model, tp, ep)
    if tp and not any(a == "model" for a, _ in table.values()):
        raise ValueError(
            "tensor parallelism requested (mesh 'model' axis > 1) but no "
            "parameter of this model matches the TP layout table "
            "(parallel/mesh._tp_spec covers ViT/AFT/Hamburger attention, the "
            "MLP block, and gMLP/GatedNNMF U/V). Silently replicating would "
            "waste the model-axis devices -- run this model on a data-only "
            "mesh.")
    if ep and not any(a == "expert" for a, _ in table.values()):
        raise ValueError(
            "expert parallelism requested (mesh 'expert' axis > 1) but the "
            "model has no MoE expert stacks (--moe-experts > 0 builds them, "
            "ops/moe.MoEMLP). Silently replicating would waste the "
            "expert-axis devices -- run this model on a data-only mesh.")
    plan = {n: s for n, s in _class_plan(model).items()
            if (s.axis == "model" and tp) or (s.axis == "expert" and ep)}
    if {n: (s.axis, s.dim) for n, s in plan.items()} != table:
        raise RuntimeError(
            f"the module classes cut {sorted(plan)} and JAX's tables cut "
            f"{sorted(table)}: a sharded parameter has no code that "
            "computes with its shard")
    # the NNMF after-care and Madam normalize whole tensors: none of them
    # may be cut
    cut_nnmf = [n for n in plan if "nnmf" in n.lower() or "_weights" in n]
    if cut_nnmf:
        raise RuntimeError(f"NNMF weights would be cut: {cut_nnmf}")
    return plan


def shard_params(mesh: Mesh | None, model: nn.Module) -> ParamLayout | None:
    """Lay ``model`` out on ``mesh``, in place: give every module that
    takes part its axes (``data_axis``, ``tp_axis``, ``ep_axis``), and cut
    each parameter of ``plan_layout`` to this rank's block.  Returns the
    layout (None without a mesh)."""
    if mesh is None:
        return None
    tp = mesh.axis("model") if has_model_axis(mesh) else None
    ep = mesh.axis("expert") if has_expert_axis(mesh) else None
    plan = plan_layout(model, tp is not None, ep is not None)
    for m in model.modules():
        if hasattr(type(m), "data_axis"):
            m.data_axis = mesh.axis("data")
        if tp is not None and getattr(type(m), "TP_LAYOUT", None):
            m.tp_axis = tp
        if ep is not None and getattr(type(m), "EP_PARAMS", None):
            m.ep_axis = ep
    params = dict(model.named_parameters())
    with torch.no_grad():
        for name, shard in plan.items():
            p = params[name]
            p.data = shard.cut(p.data, mesh.axis(shard.axis)).clone()
    return ParamLayout(mesh, model, plan)
