"""The port's zoo models (``vit_cifar_torch/ops/aft.py``, ``ops/gmlp.py``,
the ``ae`` family through ``get_model``, ``pos_emb=False`` and the
transplant of every ported model) against the JAX package, on the CPU.

Inputs are made with numpy from a seed; weights are the port's init carried
to the JAX side with ``flax_from_state_dict``.  Tolerances: f32 forwards
and the gradients of <out, r> (r fixed, random, of unit norm) rtol 1e-4 /
atol 1e-5, the order of sums differing; the transplant round trip is exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vit_cifar_torch.config as tconfig
import vit_cifar_tpu.config as jconfig
from test_torch_ae import _cotangent, _grads_by_name, _jax_noise, _jax_run
from vit_cifar_torch.data.augment import normalize
from vit_cifar_torch.models import get_model
from vit_cifar_torch.ops import ae_attention as tae
from vit_cifar_torch.ops import aft as taft
from vit_cifar_torch.ops import gmlp as tgmlp
from vit_cifar_torch.train.loop import _pad_eval
from vit_cifar_torch.train.steps import make_eval_step
from vit_cifar_torch.utils.transplant import (flax_from_state_dict,
                                              state_dict_from_flax)
from vit_cifar_tpu.data.augment import normalize as jax_normalize
from vit_cifar_tpu.models import get_model as jax_get_model
from vit_cifar_tpu.ops import aft as jaft
from vit_cifar_tpu.ops import gmlp as jgmlp
from vit_cifar_tpu.train.loop import _pad_eval as jax_pad_eval
from vit_cifar_tpu.train.steps import make_eval_step as jax_make_eval_step
from test_torch_nnmf import one_torch_thread  # noqa: F401 (autouse)

F32_TOL = dict(rtol=1e-4, atol=1e-5)
B, T, FEAT, FFN, HEADS = 4, 17, 32, 64, 4  # patch=4 gives T=17
TINY = dict(num_layers=2, hidden=FEAT, ffn_features=FFN, mlp_hidden=64,
            head=HEADS, patch=4, precision="32")


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _g():
    return torch.Generator().manual_seed(0)


def _check_module(jmod, tmod, seed):
    """Output and the gradients of every parameter, JAX against the port."""
    x = np.random.default_rng(seed).normal(size=(B, T, FEAT)).astype(
        np.float32)
    want, want_g = _jax_run(jmod, flax_from_state_dict(tmod), x)
    got = tmod(torch.from_numpy(x))
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)
    got_g = _grads_by_name(tmod, got)
    assert set(got_g) == set(want_g)
    for name, g in want_g.items():
        np.testing.assert_allclose(_np(got_g[name]), _np(g), **F32_TOL,
                                   err_msg=name)


AFT_CASES = {
    "full": dict(mode="full"),
    "full_factorized": dict(mode="full", factorize=True,
                            factorization_dimension=8),
    "full_no_query": dict(mode="full", query=False),
    "simple": dict(mode="simple"),
}


@pytest.mark.parametrize("case", list(AFT_CASES))
def test_aft_matches_jax(case):
    kw = AFT_CASES[case]
    jmod = jaft.AFT(features=FEAT, seq_len=T, **kw)
    tmod = taft.AFT(FEAT, T, generator=_g(), **kw)
    names = {n for n, _ in tmod.named_parameters()}
    assert ({"u", "v"} <= names) == bool(kw.get("factorize"))
    assert ("w" in names) == (kw["mode"] == "full" and not kw.get("factorize"))
    _check_module(jmod, tmod, 1)


def test_aft_head_and_modes_not_in_the_reference_raise():
    with pytest.raises(NotImplementedError, match="head"):
        taft.AFT(FEAT, T, head=2, generator=_g())
    with pytest.raises(NotImplementedError, match="local"):
        taft.AFT(FEAT, T, mode="local", generator=_g())


@pytest.mark.parametrize("cls", ["GatedMLP", "WeightGatedMLP",
                                 "LinearAttention"])
def test_gated_mixers_match_jax(cls):
    jmod = getattr(jgmlp, cls)(features=FEAT, ffn_features=FFN, seq_len=T)
    tmod = getattr(tgmlp, cls)(FEAT, FFN, T, generator=_g())
    _check_module(jmod, tmod, 2)


def test_gated_mlp_init():
    """U(-0.01, 0.01) for the TxT weight, ones for the per-token bias."""
    tmod = tgmlp.GatedMLP(FEAT, FFN, T, generator=_g())
    assert tmod.weight.shape == (T, T) and tmod.bias.shape == (1, T, 1)
    assert float(tmod.weight.detach().abs().max()) <= 0.01
    assert torch.equal(tmod.bias, torch.ones(1, T, 1))


# -- the models, through get_model -------------------------------------------

MODELS = {
    "ae_default": dict(model_name="ae", num_layers=1),
    "ae_heads": dict(model_name="ae", ae_type="heads"),
    "ae_heads_chunk": dict(model_name="ae", ae_type="heads", chunk=True),
    "ae_transpose_random": dict(model_name="ae", ae_type="transpose",
                                mask_type="random"),
    "ae_2d_chunk": dict(model_name="ae", ae_type="2d", chunk=True),
    "ae_legacy_heads": dict(model_name="ae", ae_type="heads",
                            legacy_heads=True),
    "ae_no_pos_emb": dict(model_name="ae", pos_emb=False),
    "ae_baseline": dict(model_name="ae_baseline"),
    "aftfull": dict(model_name="aftfull"),
    "aftfull_factorized_no_query": dict(model_name="aftfull", factorize=True,
                                        query=False),
    "aftsimple": dict(model_name="aftsimple", query=False),
    "gmlp": dict(model_name="gmlp"),
    "wgmlp": dict(model_name="wgmlp"),
    "linear": dict(model_name="linear"),
}


def _models(name, **extra):
    kw = dict(TINY, **MODELS[name], **extra)
    jcfg, tcfg = jconfig.Config(**kw), tconfig.Config(**kw)
    jmodel, j_unsup = jax_get_model(jcfg)
    tmodel, t_unsup = get_model(tcfg, device="cpu")
    assert t_unsup == j_unsup == (jcfg.model_name == "ae")
    if tcfg.mask_type == "random":
        for m in tmodel.modules():
            if isinstance(m, tae.AEAttention):
                m.mask_noise = _jax_noise(FFN // 2 if tcfg.chunk else FFN)
    return jcfg, jmodel, tcfg, tmodel


@pytest.mark.parametrize("name", list(MODELS))
def test_zoo_models_match_jax(name):
    """Logits and the gradient of every parameter (zeros on the JAX side
    where the port has none: the detached AE and norm1)."""
    jcfg, jmodel, _, tmodel = _models(name)
    imgs = np.random.default_rng(8).integers(0, 256, (B, 32, 32, 3),
                                             dtype=np.uint8)
    x = jax_normalize(jnp.asarray(imgs), jcfg.mean, jcfg.std)

    def jloss(p):
        logits = jmodel.apply({"params": p}, x, deterministic=True)
        return jnp.sum(logits * _cotangent(logits.shape)), logits

    (_, want), want_g = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        flax_from_state_dict(tmodel))
    logits = tmodel(normalize(torch.from_numpy(imgs), jcfg.mean, jcfg.std))
    np.testing.assert_allclose(_np(logits), _np(want), **F32_TOL)
    got_g = _grads_by_name(tmodel, logits)
    for pname, g in state_dict_from_flax(want_g).items():
        got = got_g[pname]
        got = np.zeros_like(_np(g)) if got is None else _np(got)
        np.testing.assert_allclose(got, _np(g), **F32_TOL, err_msg=pname)


@pytest.mark.parametrize("name", ["ae_default", "ae_heads_chunk",
                                  "ae_baseline", "aftfull", "aftsimple",
                                  "gmlp", "linear"])
def test_zoo_logits_match_jax_bf16(name):
    """bf16-mixed: the AE in f32 inside a bf16 model, AFT's f32 exp/ratio
    arithmetic, the mixers' casts; within 2e-2, a few bf16 rounding steps
    (2**-7 relative) at logits of order 1, as ``tests/test_torch_vit.py``
    allows the ViT."""
    jcfg, jmodel, tcfg, tmodel = _models(name, precision="bf16-mixed")
    imgs = np.random.default_rng(10).integers(0, 256, (B, 32, 32, 3),
                                              dtype=np.uint8)
    x = jax_normalize(jnp.asarray(imgs), jcfg.mean, jcfg.std).astype(
        jcfg.compute_dtype)
    want = jax.jit(lambda p: jmodel.apply({"params": p}, x))(
        flax_from_state_dict(tmodel))
    with torch.no_grad():
        got = tmodel(normalize(torch.from_numpy(imgs), tcfg.mean, tcfg.std))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got.float()), np.asarray(want, np.float32),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("name", list(MODELS))
def test_transplant_round_trip(name):
    """flax -> port -> flax: the same keys, the same arrays, every
    parameter in place (the AE's nested encoder/decoder blocks, AFT's
    w/u/v, GatedMLP's TxT ``weight``, which is no Linear's)."""
    jcfg, jmodel, _, tmodel = _models(name)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 32, 32, 3)))["params"]
    rng = np.random.default_rng(3)
    params = jax.tree_util.tree_map(
        lambda s: rng.normal(size=s.shape).astype(np.float32), shapes)
    tmodel.load_state_dict(state_dict_from_flax(params))  # strict
    back = flax_from_state_dict(tmodel)
    flat = jax.tree_util.tree_leaves_with_path(params)
    assert len(flat) == len(jax.tree_util.tree_leaves(back))
    for path, leaf in flat:
        node = back
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node, leaf)


def test_pos_emb_off_has_no_parameter():
    """Frozen zeros: no parameter, nothing added; only non-vit models read
    the flag."""
    cfg = tconfig.Config(**dict(TINY, model_name="gmlp", pos_emb=False))
    model, _ = get_model(cfg, device="cpu")
    assert model.pos_emb is None
    assert not any("pos_emb" in n for n, _ in model.named_parameters())
    on, _ = get_model(cfg.replace(pos_emb=True), device="cpu")
    assert on.pos_emb.shape == (1, T, FEAT)
    vit, _ = get_model(cfg.replace(model_name="vit"), device="cpu")
    assert vit.pos_emb is not None


def test_aft_padded_last_eval_batch_matches_jax():
    """The batch-axis max couples the examples of a batch, so the zero
    images padding the last eval batch change the real rows' logits: the
    masked sums still match JAX's, which pads the same way."""
    jcfg, jmodel, tcfg, tmodel = _models("aftfull")
    rng = np.random.default_rng(9)
    x = rng.integers(0, 256, (13, 32, 32, 3), dtype=np.uint8)
    y = rng.integers(0, 10, 13).astype(np.int32)
    xp, yp, mask, steps = _pad_eval(x, y, 8)
    assert steps == 2 and mask.sum() == 13
    params = flax_from_state_dict(tmodel)
    jeval = jax.jit(jax_make_eval_step(jcfg, jmodel))
    teval = make_eval_step(tcfg, tmodel)
    for s in range(steps):
        sl = slice(8 * s, 8 * (s + 1))
        want = jeval(params, {}, *(jnp.asarray(a[sl]) for a in (xp, yp,
                                                                mask)))
        got = teval(*(torch.from_numpy(a[sl]) for a in (xp, yp, mask)))
        for k in ("loss_sum", "correct_sum", "count"):
            np.testing.assert_allclose(_np(got[k]), _np(want[k]), **F32_TOL,
                                       err_msg=k)
    # the padding reaches the real rows: the last five images alone give
    # other logits than with their three zero images
    last = normalize(torch.from_numpy(xp[8:]), tcfg.mean, tcfg.std)
    with torch.no_grad():
        padded, alone = tmodel(last)[:5], tmodel(last[:5])
    assert not torch.allclose(padded, alone, **F32_TOL)
    np.testing.assert_array_equal(*(np.asarray(a) for a in (
        jax_pad_eval(x, y, 8)[0], xp)))
