"""The port's convolution (``vit_cifar_torch/ops/init.py::Conv``), the
generic stacks (``ops/basic.py``), the local-global and baseline CNNs
(``models/cnn.py``) through ``get_model``, and their training, against the
JAX package on the CPU.

Inputs are made with numpy from a seed; weights and running statistics are
the port's init carried across with ``flax_from_state_dict`` (the
statistics as ``batch_stats``), and the JAX step's batch is handed to the
port's ``on_batch``.  Shapes are not square where a layout could hide: the
grid p differs from the cls size k, and the channels from p*p.  Tolerances:
f32 module outputs and running statistics rtol 1e-5 / atol 1e-6;
gradients of <out, r> (r fixed, random, of unit norm) rtol 1e-4 / atol
1e-5, and model logits the same (sums in another order, through several
layers); the models' gradients rtol 1e-4 / atol 4e-5: the port's own
``wlgcnn`` batch_norm ``cls_token`` gradient moves by 1.9e-5 when the input
moves by one f32 ulp (its BatchNorms' backward, twice a layer).  bf16-mixed
logits 2e-2, as ``tests/test_torch_zoo.py``.  Training steps as
``tests/test_torch_gnnmf.py``: metrics, moments and running statistics
rtol 1e-4 / atol 1e-5, parameters atol 1e-4, except where Adam's update
is ill-posed: an entry whose gradient (decay included) was within 1e-7 of
zero at some step has an update of up to lr in the direction of its
rounding noise (``emb``'s bias under batch_norm, which la1 cancels, has a
zero gradient in exact arithmetic), so there the two sides are held only
to Adam's bound of 3 lr a step.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

import vit_cifar_torch.config as tconfig
import vit_cifar_tpu.config as jconfig
from test_torch_ae import _cotangent
from test_torch_ae_train import _by_name
from test_torch_nnmf import one_torch_thread  # noqa: F401
from test_torch_train import _jax_batch, _np
from vit_cifar_torch.data.augment import normalize
from vit_cifar_torch.models import cnn as tcnn
from vit_cifar_torch.models import get_model
from vit_cifar_torch.ops import basic as tbasic
from vit_cifar_torch.ops.init import Conv, he_conv_init
from vit_cifar_torch.train import loop
from vit_cifar_torch.train.optim import make_optimizer
from vit_cifar_torch.train.steps import make_train_step
from vit_cifar_torch.utils.transplant import (flax_from_state_dict,
                                              state_dict_from_flax)
from vit_cifar_tpu.data.augment import normalize as jax_normalize
from vit_cifar_tpu.models import cnn as jcnn
from vit_cifar_tpu.models import get_model as jax_get_model
from vit_cifar_tpu.ops import basic as jbasic
from vit_cifar_tpu.ops import init as jinit
from vit_cifar_tpu.train.loop import init_state as jax_init_state
from vit_cifar_tpu.train.optim import make_optimizer as jax_make_optimizer
from vit_cifar_tpu.train.steps import make_train_step as jax_make_train_step

MOD_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
MODEL_GRAD_TOL = dict(rtol=1e-4, atol=4e-5)
ADAM_FLOOR = 1e-7
F32_TOL = dict(rtol=1e-4, atol=1e-5)
PARAM_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
B = 4


def _g():
    return torch.Generator().manual_seed(0)


def _rand(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def variables_of(tmod) -> dict:
    """JAX's variables of a port module: params, and its buffers as
    ``batch_stats`` and ``state`` where it has them."""
    out = {"params": flax_from_state_dict(tmod)}
    for collection in ("batch_stats", "state"):
        tree = flax_from_state_dict(tmod, collection=collection)
        if tree:
            out[collection] = tree
    return out


def _tuple(out):
    return out if isinstance(out, tuple) else (out,)


def check_module(jmod, tmod, inputs, train: bool, out_tol=MOD_TOL,
                 grad_tol=GRAD_TOL):
    """Outputs, the gradient of every parameter and the buffers after the
    call (running statistics, bases), JAX against the port.  ``inputs``
    are numpy arrays; both sides get ``deterministic=not train``."""
    variables = variables_of(tmod)
    xs = [jnp.asarray(a) for a in inputs]

    def loss(p):
        out, upd = jmod.apply({**variables, "params": p}, *xs,
                              deterministic=not train,
                              mutable=["batch_stats", "state"])
        outs = _tuple(out)
        return sum(jnp.sum(o.astype(jnp.float32) * _cotangent(o.shape))
                   for o in outs), (outs, upd)

    (_, (want, upd)), want_g = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(variables["params"])
    got = _tuple(tmod(*[torch.from_numpy(a) for a in inputs],
                      deterministic=not train))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g.float()), np.asarray(w, np.float32),
                                   **out_tol)
    tloss = sum(torch.sum(o.float() * torch.from_numpy(
        _cotangent(tuple(o.shape)))) for o in got)
    names, params = zip(*tmod.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(tloss, params,
                                                allow_unused=True)))
    want_g = state_dict_from_flax(want_g)
    assert set(want_g) == set(grads)
    for name, w in want_g.items():
        g = grads[name]
        g = np.zeros(w.shape, np.float32) if g is None else _np(g)
        np.testing.assert_allclose(g, _np(w), **grad_tol, err_msg=name)
    bufs = dict(tmod.named_buffers())
    new = state_dict_from_flax({}, upd.get("state"), upd.get("batch_stats"))
    assert set(new) == set(bufs)
    for name, w in new.items():
        np.testing.assert_allclose(_np(bufs[name]), _np(w), **MOD_TOL,
                                   err_msg=name)
    return got


# -- the convolution ----------------------------------------------------------

CONVS = {
    "k1": dict(kernel_size=(1, 1)),
    "k2_same": dict(kernel_size=(2, 2)),
    "k3_same": dict(kernel_size=(3, 3)),
    "k2x3_same_stride2": dict(kernel_size=(2, 3), strides=(2, 2)),
    "k3_valid": dict(kernel_size=(3, 3), padding="VALID"),
    "emb_valid_stride": dict(kernel_size=(2, 2), strides=(2, 2),
                             padding="VALID"),
    "k1_stride2": dict(kernel_size=(1, 1), strides=(2, 2)),
}


@pytest.mark.parametrize("case", list(CONVS))
def test_conv_matches_jax(case):
    """NHWC in and out, flax's SAME pads ((k-1)//2 before) and VALID, on a
    non-square image; output and the gradients of weight, bias and input."""
    kw = CONVS[case]
    tmod = Conv(3, 5, generator=_g(), **kw)
    assert {n for n, _ in tmod.named_parameters()} == {"Conv_0.weight",
                                                       "Conv_0.bias"}
    jmod = jinit.TorchConv(5, **kw)
    x = _rand((2, 7, 6, 3), 1)
    params = flax_from_state_dict(tmod)

    def loss(p, xj):
        out = jmod.apply({"params": p}, xj)
        return jnp.sum(out * _cotangent(out.shape)), out

    (_, want), (want_p, want_x) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = tmod(xt)
    assert got.shape == want.shape
    np.testing.assert_allclose(_np(got), _np(want), **MOD_TOL)
    names, ps = zip(*tmod.named_parameters())
    grads = torch.autograd.grad(torch.sum(got * torch.from_numpy(
        _cotangent(tuple(got.shape)))), [*ps, xt])
    for name, g in zip(names, grads):
        np.testing.assert_allclose(_np(g), _np(state_dict_from_flax(
            want_p)[name]), **GRAD_TOL, err_msg=name)
    np.testing.assert_allclose(_np(grads[-1]), _np(want_x), **GRAD_TOL)


def test_conv_init_bounds_and_he_init():
    """torch Conv2d's U(+-1/sqrt(in*kh*kw)), and the burger's He-normal
    std sqrt(2/(kh*kw*out))."""
    w = Conv(4, 64, (3, 3), generator=_g()).Conv_0.weight.detach()
    bound = 1 / (4 * 9) ** 0.5
    assert 0.95 * bound < float(w.abs().max()) <= bound
    w = he_conv_init((256, 128, 3, 3), _g())
    assert abs(float(w.std()) / (2 / (9 * 256)) ** 0.5 - 1) < 0.02


# -- ANN and CNN --------------------------------------------------------------

class _ANN(tbasic.ANN):
    """The ANN under ``check_module``'s call: it has no train mode."""

    def forward(self, x, *, deterministic=True):
        return super().forward(x)


@pytest.mark.parametrize("layers", [(12, 16, 5), (20, 9, 7, 4)],
                         ids=["plain", "deep"])
def test_ann_matches_jax(layers):
    """Including the ReLU after the last layer."""
    tmod = _ANN(layers, generator=_g())
    jmod = jbasic.ANN(layers=layers)
    out = check_module(jmod, tmod, [_rand((B, layers[0]), 2)], train=True)[0]
    assert float(out.detach().min()) == 0.0  # the logits' ReLU


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_cnn_stack_matches_jax(train):
    """VALID 3x3 convolutions, BN, ReLU and 2x2 max-pools, two layers, on a
    non-square image."""
    tmod = tbasic.CNN((3, 4, 6), generator=_g())
    jmod = jbasic.CNN(features=(3, 4, 6))
    out = check_module(jmod, tmod, [_rand((B, 16, 12, 3), 3)], train=train)
    assert out[0].shape == (B, 2, 1, 6)
    assert tmod.output_shape(16, 12) == (2, 1)


# -- the local-global modules -------------------------------------------------

P, K_CLS, FEAT, HID = 4, 2, 6, 12  # grid 4x4, channels 6 != 16


@pytest.mark.parametrize("norm", ["layer_norm", "batch_norm"])
def test_channel_norm_matches_jax(norm):
    tmod = tcnn._ChannelNorm(norm, FEAT, dtype=torch.float32)
    with torch.no_grad():
        for p in tmod.parameters():
            p.add_(torch.from_numpy(_rand(tuple(p.shape), 4)))
    check_module(jcnn._ChannelNorm(norm), tmod, [_rand((B, P, 3, FEAT), 5)],
                 train=True)


LGC_CASES = [(False, "layer_norm", 1), (False, "batch_norm", 2),
             (False, "batch_norm", 3), (True, "layer_norm", 2),
             (True, "batch_norm", 1), (True, "batch_norm", 3)]


@pytest.mark.parametrize("weight_gated,norm,k", LGC_CASES, ids=[
    f"{'wlgc' if w else 'lgc'}-{n}-k{k}" for w, n, k in LGC_CASES])
def test_local_global_convolution_matches_jax(weight_gated, norm, k):
    """x (B, p, p, C) and the cls image (B, k, k, C) through one set of
    modules; the BN's two updates, x's first."""
    cls_t, cls_j = ((tcnn.WeightLocalGlobalConvolution,
                     jcnn.WeightLocalGlobalConvolution) if weight_gated else
                    (tcnn.LocalGlobalConvolution, jcnn.LocalGlobalConvolution))
    tmod = cls_t(FEAT, HID, P, k, norm, generator=_g())
    jmod = cls_j(features=FEAT, hidden_features=HID, kernel_size=k,
                 normalization=norm)
    check_module(jmod, tmod, [_rand((B, P, P, FEAT), 6),
                              _rand((B, k, k, FEAT), 7)], train=True)


def test_weight_local_global_convolution_checks_its_widths():
    with pytest.raises(ValueError, match="hidden_features / 2"):
        tcnn.WeightLocalGlobalConvolution(FEAT, 2 * HID, P, generator=_g())


@pytest.mark.parametrize("norm", ["layer_norm", "batch_norm"])
@pytest.mark.parametrize("use_mlp", [True, False], ids=["mlp", "no_mlp"])
def test_encoder_matches_jax(norm, use_mlp):
    """The shared norms, mixer and conv MLP (with its trailing GELU): every
    BN updates twice a call."""
    tmod = tcnn.LocalGlobalConvolutionEncoder(
        FEAT, HID, P, K_CLS, 10, normalization=norm, use_mlp=use_mlp,
        generator=_g())
    jmod = jcnn.LocalGlobalConvolutionEncoder(
        features=FEAT, hidden_features=HID, kernel_size=K_CLS, mlp_hidden=10,
        normalization=norm, use_mlp=use_mlp)
    check_module(jmod, tmod, [_rand((B, P, P, FEAT), 8),
                              _rand((B, K_CLS, K_CLS, FEAT), 9)], train=True)


def test_conv_mlp_matches_jax():
    tmod = tcnn._ConvMLP(10, FEAT, 3, generator=_g())
    jmod = jcnn._ConvMLP(mlp_hidden=10, features=FEAT, kernel_size=3)
    check_module(jmod, tmod, [_rand((B, P, 3, FEAT), 10)], train=True)


# -- the models, through get_model --------------------------------------------

TINY = dict(num_layers=1, hidden=32, ffn_features=64, mlp_hidden=64, head=4,
            patch=4, precision="32")
MODELS = {
    "lgcnn": dict(model_name="lgcnn"),
    "lgcnn_bn_k2": dict(model_name="lgcnn", cnn_normalization="batch_norm",
                        kernel_size=2),
    "lgcnn_k3_no_mlp": dict(model_name="lgcnn", kernel_size=3,
                            use_encoder_mlp=False),
    "wlgcnn": dict(model_name="wlgcnn"),
    "wlgcnn_bn": dict(model_name="wlgcnn", cnn_normalization="batch_norm"),
    "cnn_baseline": dict(model_name="cnn_baseline"),
}


def models(kw: dict):
    """The JAX model and the port's of one config, and the configs."""
    jcfg, tcfg = jconfig.Config(**kw), tconfig.Config(**kw)
    return jcfg, jax_get_model(jcfg)[0], tcfg, get_model(tcfg, device="cpu")


def images(seed):
    return np.random.default_rng(seed).integers(0, 256, (B, 32, 32, 3),
                                                dtype=np.uint8)


MODEL_CASES = [(n, True) for n in MODELS] + [
    (n, False) for n in ("lgcnn_bn_k2", "wlgcnn_bn", "cnn_baseline")]


@pytest.mark.parametrize("name,train", MODEL_CASES, ids=[
    f"{n}-{'train' if t else 'eval'}" for n, t in MODEL_CASES])
def test_cnn_models_match_jax(name, train):
    """Logits, the gradient of every parameter and the running statistics
    after the forward (the eval forward of the BatchNorm models reads
    them); not ``can_learn_unsupervised``."""
    jcfg, jmodel, _, (tmodel, unsup) = models(dict(TINY, **MODELS[name]))
    assert not unsup
    x = _np(jax_normalize(jnp.asarray(images(12)), jcfg.mean, jcfg.std))
    out = check_module(jmodel, tmodel, [np.array(x, np.float32)], train,
                       out_tol=F32_TOL, grad_tol=MODEL_GRAD_TOL)[0]
    assert out.shape == (B, 10)


@pytest.mark.parametrize("name", ["lgcnn", "lgcnn_bn_k2", "wlgcnn_bn",
                                  "cnn_baseline"])
def test_cnn_models_logits_match_jax_bf16(name):
    jcfg, jmodel, tcfg, (tmodel, _) = models(
        dict(TINY, precision="bf16-mixed", **MODELS[name]))
    imgs = images(13)
    x = jax_normalize(jnp.asarray(imgs), jcfg.mean, jcfg.std).astype(
        jcfg.compute_dtype)
    want = jax.jit(lambda v: jmodel.apply(v, x))(variables_of(tmodel))
    with torch.no_grad():
        got = tmodel(normalize(torch.from_numpy(imgs), tcfg.mean, tcfg.std))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got.float()), np.asarray(want, np.float32),
                               **BF16_TOL)


def check_round_trip(jmodel, tmodel, collections):
    """flax -> port -> flax of every collection of the JAX model's init:
    the same keys and arrays (conv kernels (kh, kw, in, out) both ways)."""
    shapes = jax.eval_shape(
        lambda: jmodel.init({"params": jax.random.PRNGKey(0),
                             "mask": jax.random.PRNGKey(1)},
                            jnp.zeros((1, 32, 32, 3))))
    rng = np.random.default_rng(3)
    variables = jax.tree_util.tree_map(
        lambda s: rng.normal(size=s.shape).astype(np.float32), shapes)
    assert set(variables) == collections
    tmodel.load_state_dict(state_dict_from_flax(
        variables["params"], variables.get("state"),
        variables.get("batch_stats")))  # strict
    for collection in variables:
        back = flax_from_state_dict(tmodel, collection=collection)
        flat = jax.tree_util.tree_leaves_with_path(variables[collection])
        assert len(flat) == len(jax.tree_util.tree_leaves(back))
        for path, leaf in flat:
            node = back
            for p in path:
                node = node[p.key]
            np.testing.assert_array_equal(node, leaf)


@pytest.mark.parametrize("name", list(MODELS))
def test_cnn_transplant_round_trip(name):
    _, jmodel, _, (tmodel, _) = models(dict(TINY, **MODELS[name]))
    bn = "batch_norm" in MODELS[name].values() or name == "cnn_baseline"
    check_round_trip(jmodel, tmodel,
                     {"params", "batch_stats"} if bn else {"params"})


def test_lgcnn_without_cls_token_raises():
    with pytest.raises(NotImplementedError, match="cls token"):
        get_model(tconfig.Config(**dict(TINY, model_name="lgcnn",
                                        is_cls_token=False)), device="cpu")


# -- training against the JAX step --------------------------------------------

N_TRAIN = 16
TRAIN = dict(TINY, batch_size=B, eval_batch_size=B, warmup_epoch=0,
             dropout=0.0)
STEP_CASES = {
    "lgcnn_bn": dict(model_name="lgcnn", cnn_normalization="batch_norm"),
    "cnn_baseline": dict(model_name="cnn_baseline"),
}


@functools.cache
def _jax_side(items: tuple):
    jcfg = jconfig.Config(**dict(items))
    jmodel, _ = jax_get_model(jcfg)
    jtx = jax_make_optimizer(jcfg, N_TRAIN // B)
    jstate = jax_init_state(jcfg, jmodel, jtx,
                            jnp.zeros((2, 32, 32, 3), jnp.float32))
    return jcfg, jstate, jax.jit(jax_make_train_step(jcfg, jmodel, jtx))


def _data():
    rng = np.random.default_rng(7)
    return (rng.integers(0, 256, (N_TRAIN, 32, 32, 3), dtype=np.uint8),
            rng.integers(0, 10, N_TRAIN).astype(np.int32),
            rng.permutation(N_TRAIN).astype(np.int32))


def _model_state(jstate) -> dict:
    return state_dict_from_flax({}, jstate.model_state.get("state"),
                                jstate.model_state.get("batch_stats"))


def _adam_state(jstate):
    return next(s for s in jax.tree_util.tree_leaves(
        jstate.opt_state, is_leaf=lambda s: hasattr(s, "mu"))
        if hasattr(s, "mu"))


def check_train_steps(kw: dict, n_steps: int):
    """``n_steps`` of the port's step against the JAX step on the same
    batches, from the JAX init: metrics, parameters, both Adam moments and
    the buffers (running statistics, bases).  Returns the port's last
    metrics."""
    jcfg, jstate, jstep = _jax_side(tuple(sorted(kw.items())))
    tcfg = tconfig.Config(**kw)
    model, _ = get_model(tcfg, device="cpu")
    start = state_dict_from_flax(jstate.params, jstate.model_state.get(
        "state"), jstate.model_state.get("batch_stats"))
    model.load_state_dict(start)
    tx = make_optimizer(tcfg, N_TRAIN // B, model)
    state = loop.init_state(tcfg, model, tx)
    step = make_train_step(tcfg, model, tx)
    x, y, perm = _data()
    jx, jy, jperm = (jnp.asarray(a) for a in (x, y, perm))
    flat, unravel = ravel_pytree(jstate.params)
    ill = np.zeros(flat.shape, bool)
    for i in range(n_steps):
        img, label = _jax_batch(jcfg, jstate, x, y, perm, i)
        mu = np.asarray(ravel_pytree(_adam_state(jstate).mu)[0])
        jstate, jm = jstep(jstate, jx, jy, jperm, i)
        state, tm = step.on_batch(state, img, label)
        g = (np.asarray(ravel_pytree(_adam_state(jstate).mu)[0])
             - tcfg.beta1 * mu) / (1.0 - tcfg.beta1)
        ill |= np.abs(g) < ADAM_FLOOR
        assert set(tm) == set(jm)
        for name in jm:
            np.testing.assert_allclose(_np(tm[name]), _np(jm[name]),
                                       **F32_TOL, err_msg=f"{name}, step {i}")
    assert float(tm["skipped_nonfinite"]) == 0.0
    sd = model.state_dict()
    ill = state_dict_from_flax(unravel(ill))
    for name, p in state_dict_from_flax(jstate.params).items():
        got, want, bad = _np(sd[name]), _np(p), _np(ill[name])
        np.testing.assert_allclose(got[~bad], want[~bad], **PARAM_TOL,
                                   err_msg=name)
        assert np.all(np.abs(got - want)[bad] <= 3 * tcfg.lr * n_steps), name
    buffers = _model_state(jstate)
    assert set(buffers) == {n for n, _ in model.named_buffers()}
    for name, b in buffers.items():
        assert not torch.equal(sd[name], start[name]), name
        np.testing.assert_allclose(_np(sd[name]), _np(b), **F32_TOL,
                                   err_msg=name)
    assert int(state.opt_state["count"]) == n_steps
    for k in ("mu", "nu"):
        want = state_dict_from_flax(unravel(getattr(_adam_state(jstate), k)))
        got = _by_name(model, state.opt_state[k])
        f = np.sqrt if k == "nu" else (lambda a: a)
        for name, w in want.items():
            np.testing.assert_allclose(f(_np(got[name])), f(_np(w)),
                                       **F32_TOL, err_msg=f"{k} {name}")
    return tm


@pytest.mark.parametrize("case,n_steps", [("lgcnn_bn", 1), ("lgcnn_bn", 3),
                                          ("cnn_baseline", 1)])
def test_cnn_train_steps_match_jax(case, n_steps):
    """lgcnn with batch_norm; and cnn_baseline, which is held to the JAX
    step, never to an accuracy: the ReLU on its logits collapses it."""
    check_train_steps(dict(TRAIN, **STEP_CASES[case]), n_steps)
