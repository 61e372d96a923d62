"""The port's gated-NNMF models (``vit_cifar_torch/ops/gated_nnmf.py``,
``gnnmf_*`` through ``get_model``), the AEViT with ``--use-nnmf-layers``,
and their training (Madam, the after-care, the persistent bases of
``--train-md-bases``, the heads NNMF AE's inner Madam, the non-finite
guard, resume and serving with the bases) against the JAX package, on the
CPU.

Weights are carried across with ``flax_from_state_dict`` /
``state_dict_from_flax`` (the persistent bases as JAX's ``state``
collection); the random bases of ``rand_init`` are JAX's own draw (its
``PRNGKey(0)`` fallback when no ``mask`` rng is given), handed to the port
through ``bases_draw``; the JAX step's batch is handed to the port's
``on_batch``.  Tolerances, with the limits of the other port tests: f32
forwards, gradients, losses and moments rtol 1e-4 / atol 1e-5 (the order of
sums differs); bf16-mixed logits 2e-2 (a few bf16 rounding steps);
parameters after Adam or Madam steps atol 1e-4 (a gradient within rounding
of zero can flip the sign of a first update of nearly lr, or of a Madam
factor 1 -+ 0.5 tanh(lr/(1-b1)), on one side); the persistent bases after
the EMA rtol 1e-4 / atol 1e-5.  A weight no optimizer may move, and resume,
are held bit for bit.  Where the reference's forward is not finite (the
feature-dim AE of NNMF layers L1-normalizes a signed input), the two sides
must be non-finite at the same places, agree where they are finite, and
the guard must skip the same steps.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

import vit_cifar_torch.config as tconfig
import vit_cifar_tpu.config as jconfig
from test_torch_ae import _cotangent, _grads_by_name
from test_torch_ae_train import _by_name, _raw
from test_torch_nnmf import _unmasked, one_torch_thread  # noqa: F401
from test_torch_train import _jax_batch, _np
from vit_cifar_torch.data.augment import normalize
from vit_cifar_torch.deploy import export_inference, load_inference
from vit_cifar_torch.models import get_model
from vit_cifar_torch.ops import gated_nnmf as tgated
from vit_cifar_torch.ops.hamburger import MatrixDecomposition2D
from vit_cifar_torch.train import loop
from vit_cifar_torch.train.checkpoint import load_checkpoint
from vit_cifar_torch.train.losses import make_criterion
from vit_cifar_torch.train.optim import frozen_mask, make_optimizer
from vit_cifar_torch.train.steps import make_train_step
from vit_cifar_torch.train.unsupervised import is_ae_param
from vit_cifar_torch.utils.transplant import (flax_from_state_dict,
                                              state_dict_from_flax)
from vit_cifar_tpu.data.augment import normalize as jax_normalize
from vit_cifar_tpu.models import get_model as jax_get_model
from vit_cifar_tpu.ops import gated_nnmf as jgated
from vit_cifar_tpu.train.loop import init_state as jax_init_state
from vit_cifar_tpu.train.optim import make_optimizer as jax_make_optimizer
from vit_cifar_tpu.train.optim import \
    warmup_cosine_epoch_schedule as jax_schedule
from vit_cifar_tpu.train.steps import make_train_step as jax_make_train_step

F32_TOL = dict(rtol=1e-4, atol=1e-5)
PARAM_TOL = dict(rtol=1e-4, atol=1e-4)
B, T, FEAT, FFN = 4, 17, 32, 64  # patch=4 gives T=17
TINY = dict(num_layers=2, hidden=FEAT, ffn_features=FFN, mlp_hidden=64,
            head=4, patch=4, precision="32")
R = 64  # the matrix decomposition's rank


def _g():
    return torch.Generator().manual_seed(0)


@functools.cache
def _jax_bases_draw(batch: int, dim: int) -> torch.Tensor:
    """The NMF bases JAX draws without a ``mask`` rng (``PRNGKey(0)``)."""
    return torch.from_numpy(np.array(jax.random.uniform(
        jax.random.PRNGKey(0), (batch, dim, R), jnp.float32)))


def _inject_draws(model, batch: int) -> None:
    for m in model.modules():
        if isinstance(m, MatrixDecomposition2D) and m.rand_init:
            m.bases_draw = _jax_bases_draw(batch, m.dim)


def _variables(tmod, params=None):
    """JAX's variables of the port module: params, and the persistent
    bases as the ``state`` collection where it has them."""
    out = {"params": flax_from_state_dict(tmod) if params is None
           else params}
    state = flax_from_state_dict(tmod, collection="state")
    if state:
        out["state"] = state
    return out


# -- GatedNNMF -----------------------------------------------------------------

GATED = {
    "ham": dict(nnmf_type="ham"),
    "ham_bases": dict(nnmf_type="ham", train_bases=True),
    "ham_depthwise": dict(nnmf_type="ham", depthwise=True),
    "sbs": dict(nnmf_type="sbs"),
    "sbs_bases_local": dict(nnmf_type="sbs", train_bases=True,
                            local_learning=True),
    "sbsed": dict(nnmf_type="sbsed"),
    "sbsed_bases": dict(nnmf_type="sbsed", train_bases=True),
}


@pytest.mark.parametrize("case", list(GATED))
def test_gated_nnmf_matches_jax(case):
    """Output and the gradient of every parameter, per backend; the
    weight of a layer that is not trainable gets zeros on both sides."""
    kw = GATED[case]
    jmod = jgated.GatedNNMF(features=FEAT, ffn_features=FFN, seq_len=T,
                            md_iter=5, **kw)
    tmod = tgated.GatedNNMF(FEAT, FFN, T, md_iter=5, generator=_g(), **kw)
    _inject_draws(tmod, B)
    x = np.random.default_rng(1).normal(size=(B, T, FEAT)).astype(
        np.float32)
    variables = _variables(tmod)

    def loss(p):
        out = jmod.apply({**variables, "params": p}, jnp.asarray(x))
        return jnp.sum(out * _cotangent(out.shape)), out

    (_, want), want_g = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        variables["params"])
    got = tmod(torch.from_numpy(x))
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)
    got_g = _grads_by_name(tmod, got)
    for name, g in state_dict_from_flax(want_g).items():
        np.testing.assert_allclose(_np(got_g[name]), _np(g), **F32_TOL,
                                   err_msg=name)
    if "nnmf_weights" in dict(tmod.NNMF.named_parameters()) and \
            not kw.get("train_bases"):
        assert not torch.any(got_g["NNMF.nnmf_weights"])


@pytest.mark.parametrize("nnmf_type", ["sbs", "sbsed"])
def test_depthwise_sbs_and_sbsed_raise(nnmf_type):
    with pytest.raises(NotImplementedError, match="depthwise"):
        tgated.GatedNNMF(FEAT, FFN, T, nnmf_type=nnmf_type, depthwise=True,
                         generator=_g())
    with pytest.raises(NotImplementedError, match="NNMF type"):
        tgated.GatedNNMF(FEAT, FFN, T, nnmf_type="nope", generator=_g())


# -- the models, through get_model ---------------------------------------------

MODELS = {
    "gnnmf_ham": dict(model_name="gnnmf_ham"),
    "gnnmf_ham_bases": dict(model_name="gnnmf_ham", train_md_bases=True),
    "gnnmf_sbs": dict(model_name="gnnmf_sbs"),
    "gnnmf_sbs_bases": dict(model_name="gnnmf_sbs", train_md_bases=True),
    "gnnmf_sbsed": dict(model_name="gnnmf_sbsed"),
    "ae_nnmf_simple": dict(model_name="ae", use_nnmf_layers=True),
    "ae_nnmf_transpose": dict(model_name="ae", use_nnmf_layers=True,
                              ae_type="transpose", mask_type="random"),
    "ae_nnmf_2d": dict(model_name="ae", use_nnmf_layers=True, ae_type="2d",
                       chunk=True),
    "ae_nnmf_legacy_heads": dict(model_name="ae", use_nnmf_layers=True,
                                 ae_type="heads", legacy_heads=True),
    "ae_nnmf_heads": dict(model_name="ae", use_nnmf_layers=True,
                          ae_type="heads"),
    "ae_nnmf_heads_chunk_random": dict(model_name="ae", use_nnmf_layers=True,
                                       ae_type="heads", chunk=True,
                                       mask_type="random"),
}


def _models(name, **extra):
    kw = dict(TINY, ae_hidden_features=16, ae_hidden_seq_len=5,
              **MODELS[name], **extra)
    jcfg, tcfg = jconfig.Config(**kw), tconfig.Config(**kw)
    jmodel, _ = jax_get_model(jcfg)
    tmodel, _ = get_model(tcfg, device="cpu")
    _inject_draws(tmodel, B)
    if tcfg.mask_type == "random":
        width = FFN // 2 if tcfg.chunk else FFN
        noise = torch.from_numpy(np.array(jax.random.normal(
            jax.random.PRNGKey(0), (B, T, T, width), jnp.float32)))
        for m in tmodel.modules():
            if hasattr(m, "mask_noise"):
                m.mask_noise = noise
    return jcfg, jmodel, tcfg, tmodel


def _images(seed):
    return np.random.default_rng(seed).integers(0, 256, (B, 32, 32, 3),
                                                dtype=np.uint8)


# the AEs of NNMF layers over a signed (LayerNormed) input: the iterate's
# ratios are ill-conditioned there, or not finite
SIGNED = ("ae_nnmf_simple", "ae_nnmf_transpose", "ae_nnmf_legacy_heads")


def _logits_and_grads(name, imgs, raise_norm1=False):
    """JAX's logits of ``name`` on the normalized ``imgs`` and their
    gradients, and the port model; with ``raise_norm1`` every ``norm1``
    bias is raised by 4 first (on both sides)."""
    jcfg, jmodel, _, tmodel = _models(name)
    if raise_norm1:
        with torch.no_grad():
            for pname, p in tmodel.named_parameters():
                if pname.endswith("norm1.bias"):
                    p += 4.0
    x = jax_normalize(jnp.asarray(imgs), jcfg.mean, jcfg.std)
    variables = _variables(tmodel)

    def jloss(p):
        logits = jmodel.apply({**variables, "params": p}, x,
                              deterministic=True)
        return jnp.sum(logits * _cotangent(logits.shape)), logits

    (_, want), want_g = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        variables["params"])
    return _np(want), want_g, jcfg, tmodel


def _assert_logits_and_grads_match(tmodel, imgs, jcfg, want, want_g):
    logits = tmodel(normalize(torch.from_numpy(imgs), jcfg.mean, jcfg.std))
    np.testing.assert_allclose(_np(logits), want, **F32_TOL)
    got_g = _grads_by_name(tmodel, logits)
    for pname, g in state_dict_from_flax(want_g).items():
        got = got_g[pname]
        got = np.zeros_like(_np(g)) if got is None else _np(got)
        np.testing.assert_allclose(got, _np(g), **F32_TOL, err_msg=pname)


@pytest.mark.parametrize("name", [n for n in MODELS if n not in SIGNED])
def test_nnmf_models_match_jax(name):
    """Logits and the gradient of every parameter (zeros on the JAX side
    where the port has none)."""
    imgs = _images(8)
    want, want_g, jcfg, tmodel = _logits_and_grads(name, imgs)
    _assert_logits_and_grads_match(tmodel, imgs, jcfg, want, want_g)


@pytest.mark.parametrize("name", SIGNED)
def test_nnmf_models_of_a_signed_input_match_jax(name):
    """The reference L1-normalizes the AE's LayerNormed, signed input
    (NNMFLinear.py:216).  Where a sum is near zero the iterate is
    ill-conditioned (JAX's own logits move by up to 0.4 when the input
    moves by one f32 ulp), or not finite: the feature-dim AE is not finite
    at all in the reference
    (tests/test_train_smoke.py::test_aece_frozen_mask_covers_ae_nnmf_weights).
    So on that input the port's logits are not finite exactly where JAX's
    are not; the arithmetic is held from norm1 biases raised by 4 on both
    sides, which makes the AE's input positive and its sums well-sized:
    there the logits and every gradient agree at the f32 limits."""
    imgs = _images(8)
    want, _, jcfg, tmodel = _logits_and_grads(name, imgs)
    with torch.no_grad():
        got = _np(tmodel(normalize(torch.from_numpy(imgs), jcfg.mean,
                                   jcfg.std)))
    finite = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), finite)
    if name == "ae_nnmf_simple":
        assert not finite.any()
    else:
        assert finite.all()
    want, want_g, jcfg, tmodel = _logits_and_grads(name, imgs,
                                                   raise_norm1=True)
    assert np.isfinite(want).all()
    _assert_logits_and_grads_match(tmodel, imgs, jcfg, want, want_g)


@pytest.mark.parametrize("name", ["gnnmf_ham_bases", "gnnmf_sbs",
                                  "gnnmf_sbsed", "ae_nnmf_heads"])
def test_nnmf_models_logits_match_jax_bf16(name):
    """bf16-mixed: the NNMF math in f32 inside a bf16 model, cast at the
    layers' edges, within 2e-2 of JAX's."""
    jcfg, jmodel, tcfg, tmodel = _models(name, precision="bf16-mixed")
    imgs = _images(10)
    x = jax_normalize(jnp.asarray(imgs), jcfg.mean, jcfg.std).astype(
        jcfg.compute_dtype)
    want = jax.jit(lambda v: jmodel.apply(v, x))(_variables(tmodel))
    with torch.no_grad():
        got = tmodel(normalize(torch.from_numpy(imgs), tcfg.mean, tcfg.std))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got.float()), np.asarray(want, np.float32),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("name", list(MODELS))
def test_nnmf_transplant_round_trip(name):
    """flax -> port -> flax, ``params`` and ``state``: the same keys and
    arrays (``nnmf_weights`` keeps its (C, M) layout)."""
    jcfg, jmodel, _, tmodel = _models(name)
    shapes = jax.eval_shape(
        lambda: jmodel.init({"params": jax.random.PRNGKey(0),
                             "mask": jax.random.PRNGKey(1)},
                            jnp.zeros((1, 32, 32, 3))))
    rng = np.random.default_rng(3)
    variables = jax.tree_util.tree_map(
        lambda s: rng.normal(size=s.shape).astype(np.float32), shapes)
    assert set(variables) == ({"params", "state"} if name ==
                              "gnnmf_ham_bases" else {"params"})
    tmodel.load_state_dict(state_dict_from_flax(
        variables["params"], variables.get("state")))  # strict
    for collection in variables:
        back = flax_from_state_dict(tmodel, collection=collection)
        flat = jax.tree_util.tree_leaves_with_path(variables[collection])
        assert len(flat) == len(jax.tree_util.tree_leaves(back))
        for path, leaf in flat:
            node = back
            for p in path:
                node = node[p.key]
            np.testing.assert_array_equal(node, leaf)


def test_get_model_builds_every_ae_type_with_nnmf_layers():
    for kw in ({}, dict(ae_type="transpose"), dict(ae_type="2d"),
               dict(ae_type="heads"), dict(ae_type="heads", chunk=True),
               dict(ae_type="heads", legacy_heads=True)):
        cfg = tconfig.Config(**dict(TINY, model_name="ae",
                                    use_nnmf_layers=True, **kw))
        model, unsup = get_model(cfg, device="cpu")
        names = [n for n, _ in model.named_parameters()]
        assert unsup and any(n.endswith("nnmf_weights") for n in names), kw
        assert not any(".fc." in n and ".AE." in n for n in names), kw


# -- training against the JAX step ---------------------------------------------

N_TRAIN = 16
TRAIN = dict(TINY, batch_size=B, eval_batch_size=B, warmup_epoch=0,
             dropout=0.0, ae_hidden_features=16, ae_hidden_seq_len=5)
CASES = {
    "sbs_madam_bases": dict(model_name="gnnmf_sbs", optimizer="madam",
                            train_md_bases=True),
    "sbsed_madam_bases": dict(model_name="gnnmf_sbsed", optimizer="madam",
                              train_md_bases=True),
    "ham_bases": dict(model_name="gnnmf_ham", train_md_bases=True),
    "sbs_frozen": dict(model_name="gnnmf_sbs", weight_decay=5e-5),
    "heads_nnmf_unsupervised": dict(model_name="ae", ae_type="heads",
                                    use_nnmf_layers=True,
                                    unsupervised_steps=1),
    "heads_nnmf_aece": dict(model_name="ae", ae_type="heads",
                            use_nnmf_layers=True, criterion="aece"),
    "nnmf_simple_nonfinite": dict(model_name="ae", use_nnmf_layers=True,
                                  weight_decay=5e-5),
}


# The heads NNMF AE L1-normalizes its LayerNormed, signed input over each
# column of heads*T tokens, and where a column's sum is small its iterate
# is chaotic: JAX's own reconstruction loss goes from 12.9 to 1.9 when the
# input moves by one f32 ulp.  Those cases start from norm1 biases raised
# by 4 (on both sides), which makes the AE's input positive and the
# comparison meaningful, as in
# test_nnmf_models_of_a_signed_input_match_jax.
POSITIVE_AE_INPUT = ("heads_nnmf_unsupervised", "heads_nnmf_aece")


def _raise_norm1_bias(params):
    def f(path, leaf):
        names = [p.key for p in path]
        return leaf + 4.0 if names[-2:] == ["norm1", "bias"] else leaf
    return jax.tree_util.tree_map_with_path(f, params)


@functools.cache
def _jax_side(case: str):
    jcfg = jconfig.Config(**TRAIN, **CASES[case])
    jmodel, _ = jax_get_model(jcfg)
    jtx = jax_make_optimizer(jcfg, N_TRAIN // B)
    jstate = jax_init_state(jcfg, jmodel, jtx,
                            jnp.zeros((2, 32, 32, 3), jnp.float32))
    if case in POSITIVE_AE_INPUT:
        jstate = jstate.replace(params=_raise_norm1_bias(jstate.params))
    return jcfg, jstate, jax.jit(jax_make_train_step(jcfg, jmodel, jtx))


def _port_side(case: str, jstate):
    tcfg = tconfig.Config(**TRAIN, **CASES[case])
    model, _ = get_model(tcfg, device="cpu")
    model.load_state_dict(state_dict_from_flax(
        jstate.params, jstate.model_state.get("state")))
    tx = make_optimizer(tcfg, N_TRAIN // B, model)
    return tcfg, model, loop.init_state(tcfg, model, tx), tx


def _data():
    rng = np.random.default_rng(7)
    return (rng.integers(0, 256, (N_TRAIN, 32, 32, 3), dtype=np.uint8),
            rng.integers(0, 10, N_TRAIN).astype(np.int32),
            rng.permutation(N_TRAIN).astype(np.int32))


def _moments(jstate, cfg) -> dict:
    """JAX's main moments by port name, ``{"mu": {...}, "nu": {...}}``."""
    if cfg.optimizer == "madam":
        inner = jstate.opt_state.inner_states
        madam_state = inner["nnmf"].inner_state
        adam_state = inner["other"].inner_state[1]
        return {k: {**_unmasked(getattr(adam_state, k)),
                    **_unmasked(getattr(madam_state, k))}
                for k in ("mu", "nu")}
    unravel = ravel_pytree(jstate.params)[1]
    adam_state = next(s for s in jax.tree_util.tree_leaves(
        jstate.opt_state, is_leaf=lambda s: hasattr(s, "mu"))
        if hasattr(s, "mu"))
    return {k: state_dict_from_flax(unravel(getattr(adam_state, k)))
            for k in ("mu", "nu")}


@pytest.mark.parametrize("n_steps", [1, 3])
@pytest.mark.parametrize("case", list(CASES))
def test_nnmf_train_steps_match_jax(case, n_steps):
    jcfg, jstate, jstep = _jax_side(case)
    tcfg, model, state, tx = _port_side(case, jstate)
    step = make_train_step(tcfg, model, tx)
    x, y, perm = _data()
    jx, jy, jperm = (jnp.asarray(a) for a in (x, y, perm))
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    for i in range(n_steps):
        img, label = _jax_batch(jcfg, jstate, x, y, perm, i)
        jstate, jm = jstep(jstate, jx, jy, jperm, i)
        state, tm = step.on_batch(state, img, label)
        assert set(tm) == set(jm)
        for name in jm:
            want, got = _np(jm[name]), _np(tm[name])
            np.testing.assert_array_equal(np.isfinite(got),
                                          np.isfinite(want))
            if np.isfinite(want):
                np.testing.assert_allclose(got, want, **F32_TOL,
                                           err_msg=f"{name}, step {i}")
    skipped = case == "nnmf_simple_nonfinite"
    assert float(tm["skipped_nonfinite"]) == float(skipped)
    sd = model.state_dict()
    for name, p in state_dict_from_flax(jstate.params).items():
        np.testing.assert_allclose(_np(sd[name]), _np(p), **PARAM_TOL,
                                   err_msg=name)
    for name, p in state_dict_from_flax(
            {}, jstate.model_state.get("state")).items():
        np.testing.assert_allclose(_np(sd[name]), _np(p), **F32_TOL,
                                   err_msg=name)
    # both moments, each on the optimizer that owns the entry
    assert int(state.opt_state["count"]) == (0 if skipped else n_steps)
    for k, want in _moments(jstate, jcfg).items():
        got = _by_name(model, state.opt_state[k])
        assert set(got) == set(want)
        f = np.sqrt if k == "nu" else (lambda a: a)
        for name, w in want.items():
            np.testing.assert_allclose(f(_np(got[name])), f(_np(w)),
                                       **F32_TOL, err_msg=f"{k} {name}")
    trainable_nnmf = {n for n in before if n.endswith("nnmf_weights") and (
        tcfg.train_md_bases or n.endswith("AE.nnmf_weights"))}
    for name, p in model.named_parameters():
        if name.endswith("nnmf_weights") and name not in trainable_nnmf:
            assert torch.equal(p, before[name]), name  # bit for bit
        elif name in trainable_nnmf:  # the after-care ran
            np.testing.assert_allclose(_np(p.sum(0)), 1.0, rtol=1e-5)
            thr = tcfg.nnmf_learning_rate_threshold_w
            assert float(p.detach().min()) >= thr / (
                1 + p.shape[0] * thr) - 1e-9
    if case in POSITIVE_AE_INPUT:
        assert all(bool((m.ae_input > 0).all()) for m in model.modules()
                   if hasattr(m, "ae_input"))
    if skipped:
        for name, p in model.named_parameters():
            assert torch.equal(p, before[name]), name
    if jstate.ae_opt_state is None:
        assert state.ae_opt_state is None
        return
    # the heads NNMF AE's Madam
    jae = jstate.ae_opt_state
    assert type(jae).__name__ == "ScaleByMadamState"
    assert int(state.ae_opt_state["count"]) == int(jae.count) == n_steps
    for k in ("mu", "nu"):
        want = state_dict_from_flax({layer: {"mixer": {"AE": tree}}
                                     for layer, tree in
                                     getattr(jae, k).items()})
        got = _by_name(model, state.ae_opt_state[k], is_ae_param)
        assert set(got) == set(want) == {
            f"enc{i}.mixer.AE.nnmf_weights" for i in range(2)}
        for name, w in want.items():
            np.testing.assert_allclose(_np(got[name]), _np(w), **F32_TOL,
                                       err_msg=f"ae {k} {name}")


def test_frozen_mask_covers_the_nnmf_weights_that_are_not_trainable():
    """Under every criterion and optimizer: the NNMFLinears of the AE and
    the gnnmf layers without --train-md-bases; never the heads AE's."""
    def frozen(**kw):
        cfg = tconfig.Config(**dict(TINY, **kw))
        model, _ = get_model(cfg, device="cpu")
        mask = frozen_mask(cfg, model)
        if mask is None:
            return set()
        return {n for n, v in _by_name(model, mask).items() if v.all()}

    assert frozen(model_name="gnnmf_sbs", optimizer="madam") == {
        "enc0.mixer.NNMF.nnmf_weights", "enc1.mixer.NNMF.nnmf_weights"}
    assert frozen(model_name="gnnmf_sbs", train_md_bases=True) == set()
    aece = frozen(model_name="ae", use_nnmf_layers=True, criterion="aece")
    assert aece == {f"enc{i}.mixer.AE.{b}.nnmf.nnmf_weights"
                    for i in range(2) for b in ("encoder", "decoder")}
    assert frozen(model_name="ae", ae_type="heads", use_nnmf_layers=True,
                  criterion="aece") == set()


def test_after_care_runs_under_ce():
    """The heads AE's weight is always trainable: under ce (the main
    optimizer leaves the AE alone) its after-care still runs, as in JAX
    (``test_heads_nnmf_ae_after_care_runs_without_train_md_bases``)."""
    cfg = tconfig.Config(**dict(TRAIN, model_name="ae", ae_type="heads",
                                use_nnmf_layers=True))
    model, _ = get_model(cfg, device="cpu")
    tx = make_optimizer(cfg, 4, model)
    state = loop.init_state(cfg, model, tx)
    w0 = model.enc0.mixer.AE.nnmf_weights.detach().clone()
    assert float(w0.min()) < 1e-3
    step = make_train_step(cfg, model, tx)
    img = torch.from_numpy(_data()[0][:B]).float() / 255
    state, m = step.on_batch(state, img, torch.arange(B))
    w = model.enc0.mixer.AE.nnmf_weights.detach()
    assert float(m["skipped_nonfinite"]) == 0.0
    assert not torch.equal(w, w0) and float(w.min()) >= 1e-3 / (
        1 + w.shape[0] * 1e-3) - 1e-9
    assert not torch.any(state.opt_state["mu"][frozen_mask(cfg, model)])


def test_remat_recomputes_with_the_bases_the_forward_read():
    """``--remat`` with persistent bases: the recomputation sees the bases
    the forward read, and the EMA is written once."""
    cfg = tconfig.Config(**dict(TRAIN, model_name="gnnmf_ham",
                                train_md_bases=True))
    x = torch.from_numpy(np.random.default_rng(5).normal(
        size=(B, 32, 32, 3)).astype(np.float32))
    label = torch.tensor([1, 2, 3, 4])
    out = []
    for remat in (False, True):
        model, _ = get_model(cfg.replace(remat=remat), device="cpu")
        loss = make_criterion(cfg)(model(x, deterministic=False), label)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        out.append((loss, grads, [b.clone() for b in model.buffers()]))
    (l0, g0, b0), (l1, g1, b1) = out
    assert torch.equal(l0, l1)
    for a, b in zip(g0 + tuple(b0), g1 + tuple(b1)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# -- the loop, resume and serving ------------------------------------------------

def _train_cfg(tmp_path, name="run", **kw):
    return tconfig.Config(**{**TRAIN, "model_name": "gnnmf_ham",
                             "train_md_bases": True, "optimizer": "madam",
                             "max_epochs": 3, "matmul_precision": "highest",
                             "synthetic_data": True, **kw},
                          log_dir=str(tmp_path / "logs"),
                          ckpt_dir=str(tmp_path / name))


def test_resume_with_bases_and_madam_is_bit_for_bit(tmp_path, monkeypatch):
    monkeypatch.setattr(loop, "load_dataset", lambda *a, **k: _raw(2))
    run = functools.partial(loop.train, verbose=False, device="cpu")
    res_a = run(_train_cfg(tmp_path, "a"))
    res_b1 = run(_train_cfg(tmp_path, "b1"), stop_after=1)
    res_b2 = run(_train_cfg(tmp_path, "b2", resume=res_b1["ckpt_dir"]))
    assert len(res_b2["history"]) == 2
    pa, _ = load_checkpoint(res_a["ckpt_dir"], prefer="last")
    pb, _ = load_checkpoint(res_b2["ckpt_dir"], prefer="last")
    assert set(pa["model_state"]) == {f"enc{i}.mixer.NNMF.bases"
                                      for i in range(2)}
    for key in ("params", "model_state", "opt_state"):
        for name in pa[key]:
            assert torch.equal(pa[key][name], pb[key][name]), (key, name)
    first = run(_train_cfg(tmp_path, "c", max_epochs=1))
    p1, _ = load_checkpoint(first["ckpt_dir"], prefer="last")
    assert not torch.equal(p1["model_state"]["enc0.mixer.NNMF.bases"],
                           pa["model_state"]["enc0.mixer.NNMF.bases"])
    for a, b in zip(res_a["history"][1:], res_b2["history"]):
        assert a == {**b, **{k: a[k] for k in ("epoch_time", "eval_time",
                                               "images_per_sec")}}
    cfg = _train_cfg(tmp_path)
    spe = 20 // B  # 2 images a class
    nnmf_schedule = jax_schedule(cfg.lr_nnmf, cfg.min_lr, cfg.warmup_epoch,
                                 cfg.max_epochs, spe)
    np.testing.assert_allclose(
        [row["lr_1"] for row in res_a["history"]],
        [float(nnmf_schedule(e * spe + 1)) for e in range(3)], rtol=1e-6)
    with open(os.path.join(res_a["log_dir"], "metrics.csv")) as f:
        assert "lr_1" in f.readline().strip().split(",")


def test_gradient_histograms_leave_the_bases_alone(tmp_path, monkeypatch):
    """The loop's gradient histograms run an extra forward: the bases it
    writes are rewound, so the run is the run without histograms."""
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


def test_served_checkpoint_keeps_its_bases(tmp_path, monkeypatch):
    """A --train-md-bases checkpoint serves with the bases it trained, as
    the JAX package's export loads the payload's model state."""
    monkeypatch.setattr(loop, "load_dataset", lambda *a, **k: _raw(2))
    res = loop.train(_train_cfg(tmp_path, max_epochs=1), verbose=False,
                     device="cpu")
    payload, cfg = load_checkpoint(res["ckpt_dir"], prefer="last")
    out = export_inference(res["ckpt_dir"], str(tmp_path / "art"),
                           which="last", device="cpu")
    with open(os.path.join(out, "serving.json")) as f:
        assert json.load(f)["model_name"] == "gnnmf_ham"
    served = load_inference(out, device="cpu")
    imgs = _images(11)
    model, _ = get_model(cfg, device="cpu")
    model.load_state_dict({**payload["params"], **payload["model_state"]})
    with torch.no_grad():
        want = model(normalize(torch.from_numpy(imgs), cfg.mean, cfg.std))
        fresh, _ = get_model(cfg, device="cpu")
        fresh.load_state_dict(payload["params"], strict=False)
        other = fresh(normalize(torch.from_numpy(imgs), cfg.mean, cfg.std))
    got = served.predict(imgs)
    np.testing.assert_array_equal(got, _np(want))
    assert not np.array_equal(got, _np(other))  # the bases matter
