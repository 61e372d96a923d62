"""The port's BatchNorm (``vit_cifar_torch/ops/norm.py``) against the JAX
package's ``TorchBatchNorm``, and its running statistics through the
training machinery: the non-finite guard, the gradient histograms' rewind,
``--remat``, resume and serving, on the CPU.

Inputs are made with numpy from a seed; the affine parameters and the
running statistics are carried across with ``flax_from_state_dict`` (the
statistics as JAX's ``batch_stats``).  Tolerances: f32 outputs, running
mean and var and gradients rtol 1e-5 / atol 1e-6 (the same f32 reductions
in another order); bf16 outputs 2e-2 (a few bf16 roundings, as
``tests/test_torch_zoo.py``), the statistics, kept in f32, 1e-5.  The
machinery tests compare the port with itself and are exact.
"""

import functools
import json
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vit_cifar_torch.config as tconfig
from test_torch_ae import _cotangent
from test_torch_ae_train import _raw
from test_torch_nnmf import one_torch_thread  # noqa: F401
from test_torch_train import _np
from vit_cifar_torch.data.augment import normalize
from vit_cifar_torch.deploy import export_inference, load_inference
from vit_cifar_torch.models import get_model
from vit_cifar_torch.ops.norm import TorchBatchNorm
from vit_cifar_torch.train import loop
from vit_cifar_torch.train.checkpoint import load_checkpoint
from vit_cifar_torch.train.losses import make_criterion
from vit_cifar_torch.train.optim import make_optimizer
from vit_cifar_torch.train.steps import make_train_step
from vit_cifar_torch.utils.transplant import flax_from_state_dict
from vit_cifar_tpu.ops import norm as jnorm

BN_TOL = dict(rtol=1e-5, atol=1e-6)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
C = 6


def _bn(momentum=0.9, dtype=torch.float32):
    """A port BatchNorm with random affine parameters."""
    bn = TorchBatchNorm(C, momentum, dtype=dtype)
    rng = np.random.default_rng(3)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(rng.normal(size=C) + 1.0))
        bn.bias.copy_(torch.from_numpy(rng.normal(size=C)))
    return bn


def _inputs(shape, n=3, dtype=np.float32):
    rng = np.random.default_rng(11)
    return [(2.0 * rng.normal(size=shape) + i).astype(dtype)
            for i in range(n)]


def _variables(tmod):
    return {"params": flax_from_state_dict(tmod),
            "batch_stats": flax_from_state_dict(tmod,
                                                collection="batch_stats")}


def _stats(tree):
    """JAX's batch_stats of a bare TorchBatchNorm, as (mean, var)."""
    return _np(tree["mean"]), _np(tree["var"])


@functools.cache
def _jax_apply(momentum, train):
    mod = jnorm.TorchBatchNorm(momentum=momentum)
    if train:
        return jax.jit(lambda v, x: mod.apply(
            v, x, use_running_average=False, mutable=["batch_stats"]))
    return jax.jit(lambda v, x: mod.apply(v, x, use_running_average=True))


SHAPES = {"nhwc": (4, 3, 5, C), "2d": (7, C), "3d": (2, 9, C)}


@pytest.mark.parametrize("momentum", [0.9, 1.0 - 3e-4],
                         ids=["flax_0.9", "burger_0.9997"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_batchnorm_train_stats_and_eval_match_jax(shape, momentum):
    """Three training calls (output, running mean and var after each), then
    the eval output from the statistics they left."""
    tmod = _bn(momentum)
    variables = _variables(tmod)
    xs = _inputs(SHAPES[shape], n=4)
    for x in xs[:3]:
        want, upd = _jax_apply(momentum, True)(variables, jnp.asarray(x))
        variables = {**variables, **upd}
        got = tmod(torch.from_numpy(x), deterministic=False)
        np.testing.assert_allclose(_np(got), _np(want), **BN_TOL)
        mean, var = _stats(upd["batch_stats"])
        np.testing.assert_allclose(_np(tmod.mean), mean, **BN_TOL)
        np.testing.assert_allclose(_np(tmod.var), var, **BN_TOL)
    # the unbiased variance went into var: not flax's biased rule
    assert not np.allclose(_np(tmod.var), 1.0)
    want = _jax_apply(momentum, False)(variables, jnp.asarray(xs[3]))
    with torch.no_grad():
        got = tmod(torch.from_numpy(xs[3]))
    np.testing.assert_allclose(_np(got), _np(want), **BN_TOL)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_batchnorm_grads_match_jax(train):
    tmod = _bn()
    variables = _variables(tmod)
    with torch.no_grad():
        tmod.mean.copy_(torch.linspace(-1.0, 1.0, C))
        tmod.var.copy_(torch.linspace(0.5, 2.0, C))
    variables["batch_stats"] = flax_from_state_dict(
        tmod, collection="batch_stats")
    x = _inputs(SHAPES["nhwc"], n=1)[0]
    r = _cotangent(x.shape)
    mod = jnorm.TorchBatchNorm(momentum=0.9)

    def loss(p, xj):
        out = mod.apply({**variables, "params": p}, xj,
                        use_running_average=not train,
                        mutable=["batch_stats"] if train else False)
        out = out[0] if train else out
        return jnp.sum(out * r)

    want_p, want_x = jax.jit(jax.grad(loss, argnums=(0, 1)))(
        variables["params"], jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = tmod(xt, deterministic=not train)
    gw, gb, gx = torch.autograd.grad(torch.sum(out * torch.from_numpy(r)),
                                     [tmod.weight, tmod.bias, xt])
    np.testing.assert_allclose(_np(gw), _np(want_p["scale"]), **BN_TOL)
    np.testing.assert_allclose(_np(gb), _np(want_p["bias"]), **BN_TOL)
    np.testing.assert_allclose(_np(gx), _np(want_x), rtol=1e-5, atol=1e-5)


class _Twice(fnn.Module):
    """One flax BatchNorm applied to x and then to y."""

    @fnn.compact
    def __call__(self, x, y):
        bn = jnorm.TorchBatchNorm(momentum=0.9, use_running_average=False)
        return bn(x), bn(y)


def test_shared_batchnorm_updates_twice_in_call_order():
    """The reference's BN shared by x and the cls token: two updates in one
    forward, x's first."""
    tmod = _bn()
    x, y, _ = _inputs(SHAPES["nhwc"])
    variables = {k: {"TorchBatchNorm_0": v}
                 for k, v in _variables(tmod).items()}
    (want_x, want_y), upd = jax.jit(lambda v, a, b: _Twice().apply(
        v, a, b, mutable=["batch_stats"]))(variables, jnp.asarray(x),
                                           jnp.asarray(y[:2]))
    got_x = tmod(torch.from_numpy(x), deterministic=False)
    got_y = tmod(torch.from_numpy(y[:2]), deterministic=False)
    np.testing.assert_allclose(_np(got_x), _np(want_x), **BN_TOL)
    np.testing.assert_allclose(_np(got_y), _np(want_y), **BN_TOL)
    mean, var = _stats(upd["batch_stats"]["TorchBatchNorm_0"])
    np.testing.assert_allclose(_np(tmod.mean), mean, **BN_TOL)
    np.testing.assert_allclose(_np(tmod.var), var, **BN_TOL)
    # in the other order the statistics differ
    other = _bn()
    other(torch.from_numpy(y[:2]), deterministic=False)
    other(torch.from_numpy(x), deterministic=False)
    assert not np.allclose(_np(other.mean), mean, **BN_TOL)


def test_batch_constant_input_normalizes_to_the_bias_in_training():
    """The cls token enters layer 0 of lgcnn the same for every image: in
    training its batch variance is 0, so BatchNorm gives the bias (up to
    rounding times 1/sqrt(eps)), while the eval path normalizes it by the
    running statistics.  So a BatchNorm lgcnn's eval logits are not its
    training logits; JAX's TorchBatchNorm does the same."""
    tmod = _bn()
    variables = _variables(tmod)
    cls = np.broadcast_to(_inputs((1, 1, 1, C), n=1)[0], (8, 1, 1, C))
    cls = np.ascontiguousarray(cls)
    want, _ = _jax_apply(0.9, True)(variables, jnp.asarray(cls))
    got = tmod(torch.from_numpy(cls), deterministic=False)
    bias = np.broadcast_to(_np(tmod.bias), cls.shape)
    np.testing.assert_allclose(_np(got), bias, rtol=0, atol=1e-3)
    np.testing.assert_allclose(_np(want), bias, rtol=0, atol=1e-3)
    with torch.no_grad():
        assert not np.allclose(_np(tmod(torch.from_numpy(cls))), bias,
                               atol=1e-1)


@pytest.mark.parametrize("shape", [(1, C), (1, 1, 1, C)])
def test_one_value_per_channel_raises_in_training(shape):
    x = torch.ones(shape)
    with pytest.raises(ValueError, match="expected more than 1 value per "
                                         "channel when training"):
        _bn()(x, deterministic=False)
    assert _bn()(x).shape == shape  # the running statistics take it


def test_batchnorm_bf16_matches_jax():
    """A bf16 input is normalized in f32 and the output cast to bf16; the
    statistics stay f32."""
    tmod = _bn(dtype=torch.bfloat16)
    variables = _variables(tmod)
    x = torch.from_numpy(_inputs(SHAPES["nhwc"], n=1)[0]).to(torch.bfloat16)
    mod = jnorm.TorchBatchNorm(momentum=0.9, dtype=jnp.bfloat16)
    want, upd = jax.jit(lambda v, a: mod.apply(
        v, a, use_running_average=False, mutable=["batch_stats"]))(
        variables, jnp.asarray(_np(x.float()), jnp.bfloat16))
    got = tmod(x, deterministic=False)
    assert got.dtype == torch.bfloat16 and tmod.mean.dtype == torch.float32
    np.testing.assert_allclose(_np(got.float()), np.asarray(want, np.float32),
                               **BF16_TOL)
    mean, var = _stats(upd["batch_stats"])
    np.testing.assert_allclose(_np(tmod.mean), mean, **BN_TOL)
    np.testing.assert_allclose(_np(tmod.var), var, **BN_TOL)


# -- the running statistics through the training machinery --------------------

B = 4
TRAIN = dict(num_layers=2, hidden=32, ffn_features=64, mlp_hidden=64, head=4,
             patch=4, batch_size=B, eval_batch_size=B, warmup_epoch=0,
             dropout=0.0, precision="32")
LGCNN_BN = dict(model_name="lgcnn", cnn_normalization="batch_norm")


def _bn_buffers(model) -> dict:
    return {n: b.clone() for n, b in model.named_buffers()}


def test_guard_keeps_the_statistics_of_a_skipped_step():
    """A step whose loss is not finite is skipped (parameters and moments
    kept), but the running statistics its forward wrote stay, as JAX keeps
    ``new_model_state``."""
    cfg = tconfig.Config(**TRAIN, **LGCNN_BN)
    models = [get_model(cfg, device="cpu")[0] for _ in range(2)]
    for m in models:
        with torch.no_grad():
            m.fc.bias[0] = float("inf")
    model, twin = models
    tx = make_optimizer(cfg, 4, model)
    state = loop.init_state(cfg, model, tx)
    x = torch.from_numpy(np.random.default_rng(5).normal(
        size=(B, 32, 32, 3)).astype(np.float32))
    start, params = _bn_buffers(model), state.params.clone()
    state, m = make_train_step(cfg, model, tx).on_batch(
        state, x, torch.arange(B))
    assert float(m["skipped_nonfinite"]) == 1.0
    assert torch.equal(state.params, params)
    with torch.no_grad():
        twin(x, deterministic=False)
    moved = 0
    for name, buf in model.named_buffers():
        assert torch.equal(buf, dict(twin.named_buffers())[name]), name
        moved += not torch.equal(buf, start[name])
    # 2 layers of la1, the mixer's norm and la2, a mean and a var each
    assert moved == len(start) == 2 * 3 * 2


def test_remat_updates_the_statistics_once():
    """``--remat`` around blocks with BatchNorm (the hamburger V1 burger):
    the recomputation reads the statistics the forward read and leaves them
    as the forward wrote them."""
    cfg = tconfig.Config(**dict(TRAIN, model_name="hamburger", num_layers=1))
    x = torch.from_numpy(np.random.default_rng(5).normal(
        size=(B, 32, 32, 3)).astype(np.float32))
    label = torch.tensor([1, 2, 3, 4])
    out = []
    for remat in (False, True):
        model, _ = get_model(cfg.replace(remat=remat), device="cpu")
        loss = make_criterion(cfg)(model(x, deterministic=False), label)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        out.append((loss, grads, _bn_buffers(model)))
    (l0, g0, b0), (l1, g1, b1) = out
    assert torch.equal(l0, l1)
    for a, b in zip(g0, g1):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert set(b0) == {"enc0.mixer.burger.upper_bn.TorchBatchNorm_0.mean",
                       "enc0.mixer.burger.upper_bn.TorchBatchNorm_0.var"}
    for name in b0:
        assert torch.equal(b0[name], b1[name]), name
    fresh = get_model(cfg, device="cpu")[0]
    assert not torch.equal(b1[next(iter(b1))],
                           dict(fresh.named_buffers())[next(iter(b1))])


def _train_cfg(tmp_path, name="run", **kw):
    return tconfig.Config(**{**TRAIN, **LGCNN_BN, "max_epochs": 3,
                             "matmul_precision": "highest",
                             "synthetic_data": True, **kw},
                          log_dir=str(tmp_path / "logs"),
                          ckpt_dir=str(tmp_path / name))


def test_resume_keeps_the_statistics_bit_for_bit(tmp_path, monkeypatch):
    monkeypatch.setattr(loop, "load_dataset", lambda *a, **k: _raw(2))
    run = functools.partial(loop.train, verbose=False, device="cpu")
    res_a = run(_train_cfg(tmp_path, "a"))
    res_b1 = run(_train_cfg(tmp_path, "b1"), stop_after=1)
    res_b2 = run(_train_cfg(tmp_path, "b2", resume=res_b1["ckpt_dir"]))
    pa, _ = load_checkpoint(res_a["ckpt_dir"], prefer="last")
    pb, _ = load_checkpoint(res_b2["ckpt_dir"], prefer="last")
    pb1, _ = load_checkpoint(res_b1["ckpt_dir"], prefer="last")
    assert len(pa["model_state"]) == 2 * 2 * 3  # 2 layers, 3 norms
    assert all(n.endswith(("TorchBatchNorm_0.mean", "TorchBatchNorm_0.var"))
               for n in pa["model_state"])
    for key in ("params", "model_state", "opt_state"):
        for name in pa[key]:
            assert torch.equal(pa[key][name], pb[key][name]), (key, name)
    name = "enc0.la1.TorchBatchNorm_0.var"
    assert not torch.equal(pb1["model_state"][name], pa["model_state"][name])
    for a, b in zip(res_a["history"][1:], res_b2["history"]):
        assert a == {**b, **{k: a[k] for k in ("epoch_time", "eval_time",
                                               "images_per_sec")}}


def test_gradient_histograms_leave_the_statistics_alone(tmp_path,
                                                        monkeypatch):
    """The histograms' extra forward writes the statistics; the loop
    rewinds them, so the run is the run without histograms."""
    monkeypatch.setattr(loop, "load_dataset", lambda *a, **k: _raw(2))
    run = functools.partial(loop.train, verbose=False, device="cpu")
    plain = run(_train_cfg(tmp_path, "a", max_epochs=1))
    logged = run(_train_cfg(tmp_path, "b", max_epochs=1, log_gradients=True,
                            log_gradients_interval=2))
    pa, _ = load_checkpoint(plain["ckpt_dir"], prefer="last")
    pb, _ = load_checkpoint(logged["ckpt_dir"], prefer="last")
    for key in ("params", "model_state"):
        for name in pa[key]:
            assert torch.equal(pa[key][name], pb[key][name]), (key, name)


def test_served_checkpoint_uses_its_statistics(tmp_path, monkeypatch):
    """The artifact of a BatchNorm model serves the eval path's logits, from
    the running statistics it trained."""
    monkeypatch.setattr(loop, "load_dataset", lambda *a, **k: _raw(2))
    res = loop.train(_train_cfg(tmp_path, max_epochs=1), verbose=False,
                     device="cpu")
    payload, cfg = load_checkpoint(res["ckpt_dir"], prefer="last")
    out = export_inference(res["ckpt_dir"], str(tmp_path / "art"),
                           which="last", device="cpu")
    with open(os.path.join(out, "serving.json")) as f:
        assert json.load(f)["model_name"] == "lgcnn"
    served = load_inference(out, device="cpu")
    imgs = np.random.default_rng(11).integers(0, 256, (B, 32, 32, 3),
                                              dtype=np.uint8)
    model, _ = get_model(cfg, device="cpu")
    model.load_state_dict({**payload["params"], **payload["model_state"]})
    fresh, _ = get_model(cfg, device="cpu")
    fresh.load_state_dict(payload["params"], strict=False)
    x = normalize(torch.from_numpy(imgs), cfg.mean, cfg.std)
    with torch.no_grad():
        want, other = model(x), fresh(x)
    got = served.predict(imgs)
    np.testing.assert_array_equal(got, _np(want))
    assert not np.allclose(got, _np(other))  # the statistics matter
