"""The port's NNMF stack (``vit_cifar_torch/ops/nnmf/``: the iterate and its
hand-derived backward, ``unfold``/``fold``, the layers, the after-care and
Madam) and ``MatrixDecomposition2D`` (``ops/hamburger.py``) against the JAX
package, on the CPU.

Inputs are made with numpy from a seed; weights are the port's init carried
to the JAX module with ``flax_from_state_dict`` (the persistent bases with
``collection="state"``); the random bases are JAX's own draw (its
``PRNGKey(0)`` fallback), handed to the port through ``bases_draw``.
Tolerances, each with its reason:

* f32 forwards and backwards: rtol 1e-4 / atol 1e-5, the order of sums
  differing between the two sides (the limits of the other port tests);
* the elementwise after-care and Madam: rtol 1e-6 / atol 1e-7, a few f32
  ulps (a column sum's order, ``tanh`` and ``pow`` in the last bit);
* a weight whose layer is not trainable: exact.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

import vit_cifar_torch.config as tconfig
import vit_cifar_tpu.config as jconfig
from vit_cifar_torch.ops import hamburger as tham
from vit_cifar_torch.ops.autoencoders import Autoencoder
from vit_cifar_torch.ops.nnmf import functional as tfn
from vit_cifar_torch.ops.nnmf import layers as tlayers
from vit_cifar_torch.ops.nnmf.optimizer import madam
from vit_cifar_torch.train.optim import (flatten_params, make_optimizer,
                                         warmup_cosine_epoch_schedule)
from vit_cifar_torch.utils.transplant import (flax_from_state_dict,
                                              state_dict_from_flax)
from vit_cifar_tpu.ops import hamburger as jham
from vit_cifar_tpu.ops.nnmf import functional as jfn
from vit_cifar_tpu.ops.nnmf import layers as jlayers
from vit_cifar_tpu.ops.nnmf.optimizer import scale_by_madam
from vit_cifar_tpu.train.optim import make_optimizer as jax_make_optimizer
from vit_cifar_tpu.train.optim import \
    warmup_cosine_epoch_schedule as jax_schedule

@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's side at these tests' small sizes: torch's intra-op
    threads would only contend with the other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


F32_TOL = dict(rtol=1e-4, atol=1e-5)
EXACT = dict(rtol=1e-6, atol=1e-7)


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _g():
    return torch.Generator().manual_seed(0)


def _uniform(seed, shape):
    return np.random.default_rng(seed).uniform(size=shape).astype(np.float32)


def _cotangent(shape, seed=99):
    r = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return r / np.linalg.norm(r)


# -- the NNMF op -------------------------------------------------------------

FLAGS = ("local_learning", "output_layer", "w_trainable", "scale_grad",
         "clamp_grad")


@pytest.mark.parametrize("flags", [
    dict(zip(FLAGS, bits)) for bits in np.ndindex(*(2,) * len(FLAGS))],
    ids=lambda f: "".join(str(int(v)) for v in f.values()))
def test_nnmf_op_forward_and_custom_backward_match_jax(flags):
    """h, and the reference's backward rule (not the forward's gradient)
    against ``jax.vjp`` of ``make_nnmf_op``, over the flag grid."""
    flags = {k: bool(v) for k, v in flags.items()}
    inp = _uniform(0, (3, 12, 5))
    inp = inp / inp.sum(axis=1, keepdims=True)
    w = _uniform(1, (12, 7))
    w = w / w.sum(axis=0, keepdims=True)
    g = 3 * np.random.default_rng(2).normal(size=(3, 7, 5)).astype(
        np.float32)
    kw = dict(iterations=5, **flags)
    h_j, vjp = jax.vjp(jfn.make_nnmf_op(**kw), jnp.asarray(inp),
                       jnp.asarray(w))
    gi_j, gw_j = vjp(jnp.asarray(g))
    ti = torch.from_numpy(inp).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    h_t = tfn.make_nnmf_op(**kw)(ti, tw)
    gi_t, gw_t = torch.autograd.grad(h_t, (ti, tw), torch.from_numpy(g))
    np.testing.assert_allclose(_np(h_t), _np(h_j), **F32_TOL)
    np.testing.assert_allclose(_np(gi_t), _np(gi_j), **F32_TOL)
    np.testing.assert_allclose(_np(gw_t), _np(gw_j), **F32_TOL)
    if not flags["w_trainable"]:
        assert not torch.any(gw_t)
    # the forward keeps no graph: h is the Function's output
    assert h_t.grad_fn.__class__.__name__.startswith("NNMFFunction")


def test_nnmf_op_with_eps0_zero_and_auto_eps_matches_jax():
    inp = _uniform(3, (2, 9, 4))
    w = _uniform(4, (9, 5))
    for kw in (dict(eps0=0.0), dict(eps=1e-5, w_trainable=True)):
        want = jfn.make_nnmf_op(6, **kw)(jnp.asarray(inp), jnp.asarray(w))
        got = tfn.make_nnmf_op(6, **kw)(torch.from_numpy(inp),
                                        torch.from_numpy(w))
        np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)


def test_nnmf_op_returns_no_weight_gradient_autograd_does_not_need():
    inp = torch.from_numpy(_uniform(5, (2, 6, 3))).requires_grad_()
    w = torch.from_numpy(_uniform(6, (6, 4)))  # no grad wanted
    h = tfn.make_nnmf_op(3, w_trainable=True)(inp, w)
    (gi,) = torch.autograd.grad(h.sum(), (inp,))
    assert gi.shape == inp.shape and w.grad is None


UNFOLD_CASES = [((3, 3), (1, 1), (0, 0)), ((2, 3), (2, 1), (1, 0)),
                ((7, 1), (1, 1), (0, 0)), ((7, 5), (1, 1), (0, 0)),
                ((3, 2), (2, 2), (1, 1))]


@pytest.mark.parametrize("kernel,strides,padding", UNFOLD_CASES)
def test_unfold_and_fold_match_jax(kernel, strides, padding):
    x = _uniform(7, (2, 3, 7, 5))
    want = jfn.unfold(jnp.asarray(x), kernel, strides, padding)
    got = tfn.unfold(torch.from_numpy(x), kernel, strides, padding)
    np.testing.assert_array_equal(_np(got), _np(want))
    assert tfn.conv_output_size((7, 5), kernel, strides, padding) == \
        jfn.conv_output_size((7, 5), kernel, strides, padding) == \
        tuple(got.shape[2:])
    patches = _uniform(8, tuple(got.shape))
    want = jfn.fold(jnp.asarray(patches), (7, 5), kernel, strides, padding)
    got = tfn.fold(torch.from_numpy(patches), (7, 5), kernel, strides,
                   padding)
    np.testing.assert_allclose(_np(got), _np(want), **EXACT)


# -- the layers --------------------------------------------------------------

def _run_layer(jmod, tmod, x):
    """Both layers on ``x``: outputs, the gradients of <out, r> for the
    input and the weight, and (Auto layer) the hidden activity."""
    params = flax_from_state_dict(tmod)

    def loss(p, xj):
        out, st = jmod.apply({"params": p}, xj, mutable=["intermediates"])
        return jnp.sum(out * _cotangent(out.shape)), (out, st)

    (_, (out_j, st)), (gw_j, gx_j) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    out_t = tmod(xt)
    gx_t, gw_t = torch.autograd.grad(
        out_t, (xt, tmod.nnmf_weights),
        torch.from_numpy(_cotangent(tuple(out_t.shape))))
    np.testing.assert_allclose(_np(out_t), _np(out_j), **F32_TOL)
    np.testing.assert_allclose(_np(gx_t), _np(gx_j), **F32_TOL)
    np.testing.assert_allclose(_np(gw_t), _np(gw_j["nnmf_weights"]),
                               **F32_TOL)
    hidden = st.get("intermediates", {}).get("hidden_activity")
    if hidden is not None:
        np.testing.assert_allclose(_np(tmod.hidden_activity),
                                   _np(hidden[0]), **F32_TOL)
    return out_t


CONV = dict(number_of_input_neurons=2, number_of_neurons=6,
            input_size=(7, 5), number_of_iterations=4)
LAYERS = {
    "conv_column": (dict(CONV, number_of_input_neurons=1,
                         forward_kernel_size=(7, 1), w_trainable=True,
                         disable_scale_grade=False), (3, 1, 7, 5)),
    "conv_strided_local": (dict(CONV, forward_kernel_size=(3, 2),
                                strides=(2, 1), padding=(1, 0),
                                w_trainable=True, local_learning=True),
                           (3, 2, 7, 5)),
    "conv_frozen": (dict(CONV, forward_kernel_size=(3, 3)), (3, 2, 7, 5)),
}
AUTO = {
    "whole_input": dict(CONV, forward_kernel_size=(7, 5), w_trainable=True),
    "column": dict(CONV, number_of_input_neurons=1,
                   forward_kernel_size=(7, 1), w_trainable=True),
    "overlapping": dict(CONV, forward_kernel_size=(3, 2), w_trainable=True,
                        disable_scale_grade=False),
}


@pytest.mark.parametrize("case", list(LAYERS))
def test_nnmf_conv2d_matches_jax(case):
    kw, shape = LAYERS[case]
    tmod = tlayers.NNMFConv2d(generator=_g(), **kw)
    out = _run_layer(jlayers.NNMFConv2d(**kw), tmod, _uniform(9, shape))
    assert out.shape == (3, 6) + tfn.conv_output_size(
        (7, 5), kw["forward_kernel_size"], kw.get("strides", (1, 1)),
        kw.get("padding", (0, 0)))
    if not kw.get("w_trainable"):
        assert not torch.any(torch.autograd.grad(
            tmod(torch.from_numpy(_uniform(9, shape))).sum(),
            tmod.nnmf_weights)[0])


@pytest.mark.parametrize("framing", list(AUTO))
def test_auto_nnmf_layer_matches_jax_in_each_framing(framing):
    kw = AUTO[framing]
    shape = (3, kw["number_of_input_neurons"], 7, 5)
    tmod = tlayers.AutoNNMFLayer(generator=_g(), **kw)
    out = _run_layer(jlayers.AutoNNMFLayer(**kw), tmod, _uniform(10, shape))
    assert out.shape == shape
    assert not tmod.hidden_activity.requires_grad


@pytest.mark.parametrize("kernel", [(7, 5), (3, 2)])
def test_nnmf_encoder_decoder_matches_jax(kernel):
    kw = dict(CONV, forward_kernel_size=kernel, w_trainable=True)
    out = _run_layer(jlayers.NNMFEncoderDecoder(**kw),
                     tlayers.NNMFEncoderDecoder(generator=_g(), **kw),
                     _uniform(11, (3, 2, 7, 5)))
    assert out.shape == (3, 2, 7, 5)


LINEAR = dict(number_of_input_neurons=10, number_of_neurons=4,
              number_of_iterations=7, w_trainable=True)


def test_nnmf_linear_matches_jax():
    _run_layer(jlayers.NNMFLinear(**LINEAR),
               tlayers.NNMFLinear(generator=_g(), **LINEAR),
               _uniform(12, (6, 10)))


def _np_forward64(inp, w, iterations):
    """The NNMF iterate (NNMFLayerSbSBP.py:343-361) in numpy f64, over
    (B, C) inputs."""
    h = np.full((inp.shape[0], w.shape[1]), 1.0 / w.shape[1])
    for _ in range(iterations):
        h = h + h * ((inp / (h @ w.T + 1e-20)) @ w)
        h = h / (h.sum(axis=1, keepdims=True) + 1e-20)
    return h


def test_nnmf_linear_of_a_signed_input():
    """The reference L1-normalizes a signed input as it is (the AE's
    LayerNormed input, NNMFLinear.py:216).  A row whose sum is near zero or
    negative makes the iterate ill-conditioned: there, two f32 evaluations
    that sum in another order part by far more than their rounding (both
    sides stray from the f64 value), so such rows are held in f64, where
    the port's arithmetic must agree with an independent numpy loop.  The
    rows with a positive, well-sized sum agree with JAX at the f32 limits,
    and the non-finite values sit at the same places."""
    x = np.random.default_rng(12).normal(size=(6, 10)).astype(np.float32)
    tmod = tlayers.NNMFLinear(generator=_g(), **LINEAR)
    w = tmod.nnmf_weights.detach().numpy()
    want = np.asarray(jlayers.NNMFLinear(**LINEAR).apply(
        {"params": flax_from_state_dict(tmod)}, jnp.asarray(x)))
    got = _np(tmod(torch.from_numpy(x)))
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    sums = x.sum(axis=1)
    good = sums > 1.0
    assert good.any() and not good.all()
    np.testing.assert_allclose(got[good], want[good], **F32_TOL)
    x64 = x.astype(np.float64)
    inp = x64 / (x64.sum(axis=1, keepdims=True) + 1e-20)
    got64 = tfn.make_nnmf_op(7)(torch.from_numpy(inp)[:, :, None],
                                torch.from_numpy(w.astype(np.float64)))
    np.testing.assert_allclose(_np(got64)[:, :, 0],
                               _np_forward64(inp, w.astype(np.float64), 7),
                               rtol=1e-10, atol=1e-12)


def test_layers_compute_in_f32_and_cast_at_the_edges():
    kw = dict(AUTO["column"])
    tmod = tlayers.AutoNNMFLayer(generator=_g(), dtype=torch.bfloat16, **kw)
    x = torch.from_numpy(_uniform(13, (2, 1, 7, 5))).to(torch.bfloat16)
    out = tmod(x)
    assert out.dtype == torch.bfloat16
    assert tmod.hidden_activity.dtype == torch.float32
    assert tmod.nnmf_weights.dtype == torch.float32
    ref = tlayers.AutoNNMFLayer(generator=_g(), **kw)(x.float())
    np.testing.assert_array_equal(_np(out.float()),
                                  _np(ref.to(torch.bfloat16).float()))


def test_nnmf_weights_init_column_stochastic():
    tmod = tlayers.NNMFConv2d(generator=_g(), forward_kernel_size=(3, 3),
                              **CONV)
    w = tmod.nnmf_weights.detach()
    assert w.shape == (3 * 3 * 2, 6) and torch.all(w >= 0)
    np.testing.assert_allclose(_np(w.sum(0)), 1.0, rtol=1e-6)


def test_shape_mismatches_raise():
    with pytest.raises(ValueError, match="NNMF layer"):
        tlayers.NNMFConv2d(generator=_g(), forward_kernel_size=(3, 3),
                           **CONV)(torch.ones(1, 1, 7, 5))
    with pytest.raises(ValueError, match="NNMFLinear"):
        tlayers.NNMFLinear(5, 3, 2, generator=_g())(torch.ones(2, 4))


# -- the after-care ------------------------------------------------------------

class _Tree(nn.Module):
    """A heads AE's layer under ``AE`` (always trainable), an AE of
    NNMFLinears (divisor: the input width) and a conv layer."""

    def __init__(self):
        super().__init__()
        self.AE = tlayers.AutoNNMFLayer(generator=_g(), **AUTO["column"])
        self.ae = Autoencoder(12, 5, nnmf=True, generator=_g())
        self.conv = tlayers.NNMFConv2d(generator=_g(),
                                       forward_kernel_size=(3, 3), **CONV)
        self.lin = nn.Linear(3, 3)


@pytest.mark.parametrize("train_md_bases", [False, True])
def test_after_care_matches_jax(train_md_bases):
    tree = _Tree()
    rng = np.random.default_rng(14)
    with torch.no_grad():  # off the simplex, with entries under threshold
        for p in tree.parameters():
            p.copy_(torch.from_numpy(
                rng.uniform(0, 1, p.shape).astype(np.float32) ** 4))
    trainable = functools.partial(tlayers.nnmf_weight_trainable,
                                  train_md_bases=train_md_bases)
    params = flax_from_state_dict(tree)
    flat = flatten_params(tree)
    before = flat.clone()
    before_named = {n: p.detach().clone() for n, p in tree.named_parameters()}
    slices = tlayers.nnmf_slices(tree, trainable=trainable)
    assert len(slices) == (4 if train_md_bases else 1)
    assert sorted(d for *_, d in slices) == (
        [1, 1, 5, 12] if train_md_bases else [1])
    tlayers.nnmf_after_care(flat, slices, 0.03)
    want = state_dict_from_flax(jlayers.nnmf_after_care(
        jax.tree_util.tree_map(jnp.asarray, params), 0.03,
        trainable_fn=functools.partial(jlayers.nnmf_weight_trainable,
                                       train_md_bases=train_md_bases)))
    got = dict(tree.named_parameters())
    for name, w in want.items():
        if not name.endswith("nnmf_weights") or not trainable(
                name.split(".")):  # left alone, bit for bit
            assert torch.equal(got[name], before_named[name]), name
        np.testing.assert_allclose(_np(got[name]), _np(w), **EXACT,
                                   err_msg=name)
    assert not torch.equal(flat, before)
    w = tree.AE.nnmf_weights.detach()
    np.testing.assert_allclose(_np(w.sum(0)), 1.0, rtol=1e-6)
    assert float(w.min()) >= 0.03 / (1 + w.shape[0] * 0.03) - 1e-9


# -- Madam ---------------------------------------------------------------------

def test_madam_matches_scale_by_madam():
    """Three steps with decay under the warmup -> cosine schedule: the
    updates, the parameters and both moments."""
    args = (1e-2, 1e-5, 1, 4, 2)
    rng = np.random.default_rng(15)
    p0 = rng.uniform(0.1, 1, 200).astype(np.float32)
    grads = [rng.normal(size=200).astype(np.float32) for _ in range(3)]
    jtx = scale_by_madam(jax_schedule(*args), weight_decay=5e-2)
    jp = {"w": jnp.asarray(p0)}
    jstate = jtx.init(jp)
    ttx = madam(warmup_cosine_epoch_schedule(*args), weight_decay=5e-2)
    tp = torch.from_numpy(p0.copy())
    tstate = ttx.init(tp)
    for g in grads:
        ju, jstate = jtx.update({"w": jnp.asarray(g)}, jstate, jp)
        jp = optax.apply_updates(jp, ju)
        tu, tstate = ttx.update(torch.from_numpy(g), tstate, tp)
        tp = tp + tu
        np.testing.assert_allclose(_np(tu), _np(ju["w"]), **EXACT)
    np.testing.assert_allclose(_np(tp), _np(jp["w"]), **EXACT)
    np.testing.assert_allclose(_np(tstate["mu"]), _np(jstate.mu["w"]),
                               **EXACT)
    np.testing.assert_allclose(_np(tstate["nu"]), _np(jstate.nu["w"]),
                               **EXACT)
    assert int(tstate["count"]) == int(jstate.count) == 3
    assert torch.all(tp > 0)


def test_make_optimizer_madam_routes_like_jax():
    """Madam for the NNMF group (names holding ``nnmf`` or ``_weights``)
    under ``lr_nnmf``, Adam for the rest under ``lr``, one count."""
    from vit_cifar_torch.ops.gated_nnmf import GatedNNMF

    kw = dict(optimizer="madam", warmup_epoch=1, max_epochs=5,
              weight_decay=5e-2, lr_nnmf=3e-2)
    tmod = GatedNNMF(8, 12, 5, nnmf_type="sbs", train_bases=True,
                     generator=_g())
    params = jax.tree_util.tree_map(jnp.asarray, flax_from_state_dict(tmod))
    jtx = jax_make_optimizer(jconfig.Config(**kw), 2)
    jstate = jtx.init(params)
    flat = flatten_params(tmod)
    ttx = make_optimizer(tconfig.Config(**kw), 2, tmod)
    tstate = ttx.init(flat)
    rng = np.random.default_rng(16)
    for _ in range(5):  # warmup, then the cosine
        g = {n: torch.from_numpy(rng.normal(size=p.shape).astype(np.float32))
             for n, p in tmod.named_parameters()}
        ju, jstate = jtx.update(flax_from_state_dict(tmod, g), jstate,
                                params)
        params = optax.apply_updates(params, ju)
        tu, tstate = ttx.update(
            torch.cat([v.reshape(-1) for v in g.values()]),
            tstate, flat)
        flat.add_(tu)
    got = dict(tmod.named_parameters())
    for name, w in state_dict_from_flax(params).items():
        np.testing.assert_allclose(_np(got[name]), _np(w), **EXACT,
                                   err_msg=name)
    madam_state = jstate.inner_states["nnmf"].inner_state
    adam_state = jstate.inner_states["other"].inner_state[1]
    assert int(tstate["count"]) == int(madam_state.count) == \
        int(adam_state.count) == 5
    for k in ("mu", "nu"):
        want = {**_unmasked(getattr(adam_state, k)),
                **_unmasked(getattr(madam_state, k))}
        assert set(want) == set(got) and "NNMF.nnmf_weights" in \
            _unmasked(getattr(madam_state, k))
        offset = 0
        for name, p in got.items():
            np.testing.assert_allclose(
                _np(tstate[k][offset:offset + p.numel()].view(p.shape)),
                _np(want[name]), **EXACT, err_msg=f"{k} {name}")
            offset += p.numel()


def _unmasked(tree) -> dict:
    """The leaves of a flax-layout tree that ``multi_transform`` did not
    mask, by the port's names and in its layout."""
    nested: dict = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, optax.MaskedNode))[0]:
        if isinstance(leaf, optax.MaskedNode):
            continue
        *mod, last = (k.key for k in path)
        node = nested
        for key in mod:
            node = node.setdefault(key, {})
        node[last] = np.asarray(leaf)
    return state_dict_from_flax(nested)


# -- MatrixDecomposition2D -----------------------------------------------------

MD_X = (3, 6, 1, 5)  # (B, H, W, C): D = C = 5 spatially, N = 6


def _md_pair(ham_type, rand_init=True, spatial=True):
    D = MD_X[3] if spatial else MD_X[1] * MD_X[2]
    kw = dict(ham_type=ham_type, spatial=spatial, R=4, train_steps=3,
              eval_steps=4, rand_init=rand_init)
    jmod = jham.MatrixDecomposition2D(**kw)
    tmod = tham.MatrixDecomposition2D(D, generator=_g(), **kw)
    if rand_init:
        key = jax.random.PRNGKey(0)
        draw = (jax.random.uniform if ham_type == "NMF"
                else jax.random.normal)(key, (MD_X[0], D, 4), jnp.float32)
        tmod.bases_draw = torch.from_numpy(np.array(draw))
    return jmod, tmod


@pytest.mark.parametrize("deterministic", [True, False])
@pytest.mark.parametrize("spatial", [True, False])
@pytest.mark.parametrize("ham_type", ["NMF", "VQ", "CD"])
def test_matrix_decomposition_matches_jax(ham_type, spatial, deterministic):
    """Output and input gradient, with JAX's random bases injected."""
    jmod, tmod = _md_pair(ham_type, spatial=spatial)
    x = _uniform(17, MD_X)
    r = _cotangent(MD_X)

    def loss(xj):
        out = jmod.apply({}, xj, deterministic=deterministic)
        return jnp.sum(out * r), out

    (_, want), gx_j = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    got = tmod(xt, deterministic=deterministic)
    (gx_t,) = torch.autograd.grad(got, xt, torch.from_numpy(r))
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)
    np.testing.assert_allclose(_np(gx_t), _np(gx_j), **F32_TOL)


def test_matrix_decomposition_persistent_bases_ema_matches_jax():
    """Without ``rand_init`` the bases are a buffer: a training call writes
    their EMA as JAX's ``state`` collection gets it; an eval call leaves
    them alone."""
    jmod, tmod = _md_pair("NMF", rand_init=False)
    x = _uniform(18, MD_X)
    state = flax_from_state_dict(tmod, collection="state")
    assert set(state) == {"bases"} and state["bases"].shape == (1, 5, 4)
    before = tmod.bases.clone()
    want_eval = jmod.apply({"state": state}, jnp.asarray(x),
                           deterministic=True)
    got_eval = tmod(torch.from_numpy(x), deterministic=True)
    np.testing.assert_allclose(_np(got_eval), _np(want_eval), **F32_TOL)
    assert torch.equal(tmod.bases, before)
    want, new = jmod.apply({"state": state}, jnp.asarray(x),
                           deterministic=False, mutable=["state"])
    got = tmod(torch.from_numpy(x), deterministic=False)
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)
    assert not torch.equal(tmod.bases, before)
    np.testing.assert_allclose(_np(tmod.bases),
                               _np(new["state"]["bases"]), **F32_TOL)
    assert not tmod.bases.requires_grad


def test_matrix_decomposition_draws_bases_from_the_generator():
    """rand_init: the train call's generator gives the bases; without one
    the draw is a generator seeded 0, so eval is deterministic."""
    _, tmod = _md_pair("NMF")
    tmod.bases_draw = None
    x = torch.from_numpy(_uniform(19, MD_X))
    a = tmod(x, deterministic=True)
    assert torch.equal(a, tmod(x, deterministic=True))
    g1, g2 = (torch.Generator().manual_seed(s) for s in (1, 1))
    b = tmod(x, deterministic=False, generator=g1)
    assert torch.equal(b, tmod(x, deterministic=False, generator=g2))
    assert not torch.equal(b, tmod(x, deterministic=False, generator=g1))
