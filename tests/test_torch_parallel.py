"""The port's mesh vocabulary (``vit_cifar_torch/parallel/``) in one
process, with no process group: the layout tables against the JAX
package's ``shard_params``, the refusals, the batch checks, the mesh and
``initialize_multihost``.  The multi-rank runs are in
``tests/test_torch_parallel_mp.py`` and ``tests/test_torch_parallel_zoo_mp.py``.
"""

from __future__ import annotations

import os
import pathlib
import re
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

import vit_cifar_torch.config as tconfig
import vit_cifar_tpu.config as jconfig
from vit_cifar_torch.models import CNN_MODELS, get_model
from vit_cifar_torch.parallel.collectives import Axis, local_draw
from vit_cifar_torch.parallel.mesh import (Shard, initialize_multihost,
                                           make_mesh, plan_layout)
from vit_cifar_torch.train import loop
from vit_cifar_torch.utils.transplant import state_dict_from_flax
from vit_cifar_tpu.models import get_model as jax_get_model
from vit_cifar_tpu.parallel.mesh import make_mesh as jax_make_mesh
from vit_cifar_tpu.parallel.mesh import shard_params as jax_shard_params
from test_torch_nnmf import one_torch_thread  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]
SMALL = dict(num_layers=1, hidden=32, mlp_hidden=64, ffn_features=64,
             head=4, precision="32")


def _moe(name: str, axis: str) -> int:
    return 4 if axis == "expert" and name not in CNN_MODELS else 0


def _jax_cut(name: str, axis: str, moe: int) -> set[str] | str:
    """The port's names of the parameters JAX's ``shard_params`` cuts over
    ``axis`` on a (4,2) mesh over (data, axis); or its ValueError."""
    cfg = jconfig.Config(model_name=name, moe_experts=moe, **SMALL)
    model, _ = jax_get_model(cfg)
    k = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: model.init(
        {"params": k, "dropout": k, "mask": k}, jnp.zeros((2, 32, 32, 3)),
        deterministic=True))["params"]
    params = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype),
                                    shapes)
    try:
        laid = jax_shard_params(jax_make_mesh((4, 2), ("data", axis)), params)
    except ValueError as e:
        return str(e)
    flags = jax.tree_util.tree_map(lambda a: a.sharding.spec != P(), laid)
    return {n for n, f in state_dict_from_flax(flags).items() if bool(f)}


@pytest.mark.parametrize("axis", ["model", "expert"])
@pytest.mark.parametrize("name", tconfig.MODEL_NAMES)
def test_sharded_names_equal_jax(name, axis):
    """For every model, the parameters the port cuts (by module class)
    are those JAX's name tables cut, on the same axis; where JAX refuses
    the axis, so does the port."""
    want = _jax_cut(name, axis, _moe(name, axis))
    cfg = tconfig.Config(model_name=name, moe_experts=_moe(name, axis),
                         **SMALL)
    model, _ = get_model(cfg, device="cpu")
    tp, ep = axis == "model", axis == "expert"
    if isinstance(want, str):
        with pytest.raises(ValueError, match="data-only mesh"):
            plan_layout(model, tp, ep)
        return
    plan = plan_layout(model, tp, ep)
    assert set(plan) == want
    assert {s.axis for s in plan.values()} == {axis}


@pytest.mark.parametrize("name,axis,match", [
    ("lgcnn", "model", "no parameter of this model matches the TP layout"),
    ("vit", "expert", "no MoE expert stacks")])
def test_layouts_refused_as_jax_refuses_them(name, axis, match):
    """A model axis over a model with nothing to cut (lgcnn), and an expert
    axis over a dense model: both raise, naming a data-only mesh, in JAX
    and in the port."""
    cfg = tconfig.Config(model_name=name, **SMALL)
    with pytest.raises(ValueError, match=match):
        plan_layout(get_model(cfg, device="cpu")[0], axis == "model",
                    axis == "expert")
    assert match in _jax_cut(name, axis, 0)


@pytest.mark.parametrize("field", ["batch_size", "eval_batch_size"])
def test_batches_must_divide_over_the_data_axis(field):
    cfg = tconfig.Config(**{"batch_size": 12, "eval_batch_size": 12,
                            field: 6})
    loop._check_batches(cfg, 3)
    with pytest.raises(ValueError, match=f"{field}=6 must divide"):
        loop._check_batches(cfg, 4)


@pytest.mark.parametrize("axis", ["pipe", "seq"])
def test_pipe_and_seq_axes_wait_for_item_8b(axis, tmp_path):
    """The pipe and seq axes are ported: in a group of one process,
    ``make_mesh`` gives the axis its own group; the layout cuts nothing
    over it (the parameters stay whole, as JAX replicates them), and a
    state gathered for the checkpoint has the one-device names and shapes.
    A mesh of more devices outside torchrun raises, naming torchrun."""
    from vit_cifar_torch.parallel.mesh import shard_params
    from vit_cifar_torch.train.loop import _full_payload, init_state
    from vit_cifar_torch.train.optim import make_optimizer

    with pytest.raises(ValueError, match="torchrun"):
        make_mesh((1, 2), ("data", axis), "cpu")
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", axis), "cpu")
        assert mesh.shape == {"data": 1, axis: 1}
        assert mesh.axis(axis).size == 1 and mesh.axis(axis).rank == 0
        cfg = tconfig.Config(model_name="vit", **SMALL)
        model = get_model(cfg, device="cpu")[0]
        want = {n: tuple(p.shape) for n, p in model.named_parameters()}
        layout = shard_params(mesh, model)
        assert layout.shards == {}
        state = init_state(cfg, model, make_optimizer(cfg, 4, model))
        payload = _full_payload(state, 0, 0.0, layout)
        assert {n: tuple(p.shape) for n, p in payload["params"].items()} \
            == want
    finally:
        dist.destroy_process_group()


def test_make_mesh_against_the_world(tmp_path):
    """Outside a process group a one-device mesh is no mesh and a larger
    one raises, naming torchrun; in a group of one process, a shape whose
    product differs from the world raises, naming torchrun, and so does a
    CUDA mesh over a gloo group (no backend stands in for another)."""
    assert make_mesh((), ("data",), "cpu") is None
    assert make_mesh((1,), ("data",), "cpu") is None
    with pytest.raises(ValueError, match="torchrun"):
        make_mesh((2,), ("data",), "cpu")
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = make_mesh((), ("data", "model"), "cpu")
        assert mesh.shape == {"data": 1, "model": 1}
        assert mesh.axis("data").size == 1 and mesh.axis("expert") is None
        with pytest.raises(ValueError, match="holds 2 devices.*torchrun"):
            make_mesh((2,), ("data",), "cpu")
        with pytest.raises(ValueError, match="2 dims for the axes"):
            make_mesh((1, 1), ("data",), "cpu")
        with pytest.raises(ValueError, match="backend is gloo.*takes nccl"):
            make_mesh((), ("data",), "cuda")
    finally:
        dist.destroy_process_group()


def test_initialize_multihost_without_a_cluster_is_one_process(monkeypatch,
                                                                capsys):
    for key in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(key, raising=False)
    info = initialize_multihost(device="cpu")
    assert info == {"process_index": 0, "process_count": 1,
                    "local_device_count": 1, "global_device_count": 1}
    assert "continuing as a SINGLE process" in capsys.readouterr().out
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="described in part"):
        initialize_multihost(num_processes=2, device="cpu")


def test_initialize_multihost_fails_loud_on_bad_explicit_cluster():
    """An explicitly described cluster that cannot be joined raises: it
    never becomes a one-process run (JAX's
    ``test_initialize_multihost_fails_loud_on_bad_explicit_cluster``).  In
    a subprocess, since a process group is process-global."""
    code = textwrap.dedent("""
        import datetime, sys
        from vit_cifar_torch.parallel.mesh import initialize_multihost
        try:
            initialize_multihost("127.0.0.1:1", 2, 1, device="cpu",
                                 timeout=datetime.timedelta(seconds=2))
        except Exception as e:
            print("RAISED", type(e).__name__)
        else:
            print("SILENT")
        assert "jax" not in sys.modules
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=str(ROOT)),
                         capture_output=True, text=True, timeout=120)
    assert "RAISED" in out.stdout, out.stdout + out.stderr
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("halves", [False, True])
def test_shard_cut_and_join_round_trip(halves):
    """Each rank's block, joined in rank order, is the one-device tensor;
    with ``halves`` a rank holds its slice of each half of the dim."""
    full = torch.arange(24.0).reshape(8, 3)
    shard = Shard("model", 0, halves)
    parts = [shard.cut(full, Axis("model", None, r, 2)) for r in range(2)]
    assert torch.equal(shard.join(parts), full)
    if halves:  # rows 0-1 and 4-5 on rank 0: its z1 and z2 columns
        assert torch.equal(parts[0], full[[0, 1, 4, 5]])


def test_local_draws_tile_the_one_device_draw():
    """The global-draw rule: each rank's block of a draw cut over two axes
    is that block of the one-device draw, from the same generator state."""
    def draw(shape):
        return torch.rand(shape, generator=torch.Generator().manual_seed(5))

    want = draw((4, 3, 6))
    for r in range(2):
        for c in range(3):
            got = local_draw(draw, (2, 3, 2), ((0, Axis("data", None, r, 2)),
                                               (-1, Axis("model", None, c,
                                                         3))))
            assert torch.equal(got, want[2 * r:2 * r + 2, :, 2 * c:2 * c + 2])


def test_the_port_imports_no_jax():
    """No module of the port, not chip_smoke.py and not the multi-rank
    test worker imports jax or the JAX package."""
    files = [*sorted((ROOT / "vit_cifar_torch").rglob("*.py")),
             ROOT / "chip_smoke.py", ROOT / "tests" / "torch_parallel_worker.py"]
    pattern = re.compile(r"^\s*(import|from)\s+(jax|vit_cifar_tpu|flax|optax)\b",
                         re.M)
    bad = [str(f) for f in files if pattern.search(f.read_text())]
    assert not bad, bad
