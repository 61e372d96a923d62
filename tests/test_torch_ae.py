"""The port's AE-attention family (``vit_cifar_torch/ops/autoencoders.py``
and ``ops/ae_attention.py``) against the JAX package, on the CPU; the
``ae`` and ``ae_baseline`` models are in ``tests/test_torch_zoo.py``.

Inputs are made with numpy from a seed; weights are the port's init carried
to the JAX module with ``flax_from_state_dict`` (``state_dict_from_flax``
where the JAX state is the start).  The random mask's noise is JAX's own
draw (its ``PRNGKey(0)`` fallback, taken when no ``mask`` rng is given),
handed to the port's mixers through ``mask_noise``.  Tolerances: f32
forwards and grads rtol 1e-4 / atol 1e-5 (the order of sums differs), as
the other port tests use; gradients are those of <out, r> for a fixed
random r of unit norm, so that they are of order one.  Gradients of the
mixers are compared for U and V
(and ``norm1`` where it has a path) only where the scores are detached: the
AE and ``norm1`` get none there, zeros on the JAX side and no gradient on
the port's.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_cifar_torch.ops import ae_attention as tae
from vit_cifar_torch.ops import autoencoders as tautoenc
from vit_cifar_torch.ops.nnmf.layers import AutoNNMFLayer
from vit_cifar_torch.utils.observability import get_layer_outputs
from vit_cifar_torch.utils.transplant import (flax_from_state_dict,
                                              state_dict_from_flax)
from vit_cifar_tpu.ops import ae_attention as jae
from vit_cifar_tpu.ops import autoencoders as jautoenc
from test_torch_nnmf import one_torch_thread  # noqa: F401 (autouse)

F32_TOL = dict(rtol=1e-4, atol=1e-5)
B, T, FEAT, FFN, HEADS = 4, 17, 32, 64, 4  # patch=4 gives T=17


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _x(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _cotangent(shape):
    r = np.random.default_rng(99).normal(size=shape).astype(np.float32)
    return r / np.linalg.norm(r)


def _grads_by_name(tmod, out):
    loss = torch.sum(out * torch.from_numpy(_cotangent(tuple(out.shape))))
    names, params = zip(*tmod.named_parameters())
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return dict(zip(names, grads))


def _jax_run(jmod, params, x, **kw):
    """What ``jmod.apply`` returns and the gradients of <out, r>, by name,
    from one jitted function (one compile beats JAX's op-by-op dispatch,
    which compiles every operation at every new shape)."""
    def loss(p):
        res = jmod.apply({"params": p}, jnp.asarray(x), **kw)
        out = res[0] if isinstance(res, tuple) else res
        return jnp.sum(out * _cotangent(out.shape)), res
    (_, res), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    return res, state_dict_from_flax(grads)


@functools.cache
def _jax_noise(width: int) -> torch.Tensor:
    """The random mask's draw on the JAX side without a ``mask`` rng."""
    return torch.from_numpy(np.array(jax.random.normal(
        jax.random.PRNGKey(0), (B, T, T, width), jnp.float32)))


# -- the autoencoders --------------------------------------------------------

def _g():
    return torch.Generator().manual_seed(0)


AUTOENCODERS = {
    "simple": (lambda: jautoenc.Autoencoder(input_size=12, hidden_size=5),
               lambda: tautoenc.Autoencoder(12, 5, generator=_g()),
               [(2, 7, 12), (2, 7, 7, 12)]),
    "transpose": (lambda: jautoenc.AutoencoderT(seq_len=7, hidden_size=3),
                  lambda: tautoenc.AutoencoderT(7, 3, generator=_g()),
                  [(2, 7, 12), (2, 7, 7, 12)]),
    "heads": (lambda: jautoenc.AutoencoderH(input_size=14, hidden_size=4,
                                            heads=2),
              lambda: tautoenc.AutoencoderH(14, 4, 2, generator=_g()),
              [(2, 7, 6), (2, 7, 7, 6)]),
    **{f"2d_{o}": (
        functools.partial(lambda o: jautoenc.Autoencoder2D(
            order=o, seq=7, features=12, seq_hidden=3, features_hidden=5), o),
        functools.partial(lambda o: tautoenc.Autoencoder2D(
            o, 7, 12, 3, 5, generator=_g()), o),
        [(2, 7, 12), (2, 7, 7, 12)]) for o in ("fsfs", "sffs", "sfsf")},
}


@pytest.mark.parametrize("kind", list(AUTOENCODERS))
def test_autoencoders_match_jax(kind):
    make_j, make_t, shapes = AUTOENCODERS[kind]
    jmod, tmod = make_j(), make_t()
    params = flax_from_state_dict(tmod)
    for shape in shapes:
        x = _x(1, shape)
        (want_out, want_h), want_g = _jax_run(jmod, params, x)
        got_out, got_h = tmod(torch.from_numpy(x))
        np.testing.assert_allclose(_np(got_out), _np(want_out), **F32_TOL)
        np.testing.assert_allclose(_np(got_h), _np(want_h), **F32_TOL)
        got_g = _grads_by_name(tmod, got_out)
        assert set(got_g) == set(want_g)
        for name, g in want_g.items():
            np.testing.assert_allclose(_np(got_g[name]), _np(g), **F32_TOL,
                                       err_msg=name)


NNMF = jautoenc.NNMFParams(number_of_iterations=5, w_trainable=True)
T_NNMF = tautoenc.NNMFParams(number_of_iterations=5, w_trainable=True)
NNMF_AUTOENCODERS = {
    "simple": (lambda: jautoenc.Autoencoder(12, 5, nnmf=True,
                                            nnmf_params=NNMF),
               lambda: tautoenc.Autoencoder(12, 5, nnmf=True,
                                            nnmf_params=T_NNMF,
                                            generator=_g()),
               [(2, 7, 12), (2, 7, 7, 12)]),
    "transpose": (lambda: jautoenc.AutoencoderT(7, 3, nnmf=True,
                                                nnmf_params=NNMF),
                  lambda: tautoenc.AutoencoderT(7, 3, nnmf=True,
                                                nnmf_params=T_NNMF,
                                                generator=_g()),
                  [(2, 7, 12)]),
    "heads": (lambda: jautoenc.AutoencoderH(14, 4, 2, nnmf=True,
                                            nnmf_params=NNMF),
              lambda: tautoenc.AutoencoderH(14, 4, 2, nnmf=True,
                                            nnmf_params=T_NNMF,
                                            generator=_g()),
              [(2, 7, 6), (2, 7, 7, 6)]),
    "2d_sffs_frozen": (
        lambda: jautoenc.Autoencoder2D("sffs", 7, 12, 3, 5, nnmf=True),
        lambda: tautoenc.Autoencoder2D("sffs", 7, 12, 3, 5, nnmf=True,
                                       generator=_g()),
        [(2, 7, 12)]),
    "auto_nnmf": (lambda: jautoenc.AutoNNMF((7, 12), 4, 5),
                  lambda: tautoenc.AutoNNMF((7, 12), 4, 5, generator=_g()),
                  [(2, 7, 12), (2, 3, 7, 12)]),
}


@pytest.mark.parametrize("kind", list(NNMF_AUTOENCODERS))
def test_nnmf_autoencoders_match_jax(kind):
    """The AEs built of NNMF layers (``--use-nnmf-layers``: an NNMFLinear
    per block, no ReLU) and ``AutoNNMF``, on a non-negative input: outputs,
    hidden activity and the gradients of every weight (zeros where the
    layers are not trainable)."""
    make_j, make_t, shapes = NNMF_AUTOENCODERS[kind]
    jmod, tmod = make_j(), make_t()
    params = flax_from_state_dict(tmod)
    assert all(n.endswith("nnmf_weights") for n, _ in tmod.named_parameters())
    for shape in shapes:
        x = np.random.default_rng(1).uniform(size=shape).astype(np.float32)
        (want_out, want_h), want_g = _jax_run(jmod, params, x)
        got_out, got_h = tmod(torch.from_numpy(x))
        np.testing.assert_allclose(_np(got_out), _np(want_out), **F32_TOL)
        if want_h is None:
            assert got_h is None
        else:
            np.testing.assert_allclose(_np(got_h), _np(want_h), **F32_TOL)
        got_g = _grads_by_name(tmod, got_out)
        assert set(got_g) == set(want_g)
        for name, g in want_g.items():
            np.testing.assert_allclose(_np(got_g[name]), _np(g), **F32_TOL,
                                       err_msg=name)
            if kind.endswith("frozen"):
                assert not torch.any(got_g[name]), name


def test_nnmf_branches_raise():
    """What the NNMF branches still refuse, as the JAX package does: an
    AutoNNMF input that is neither 3-D nor 4-D, and an input of the wrong
    width or framing for the NNMF layer."""
    g = _g()
    with pytest.raises(NotImplementedError, match="AutoNNMF"):
        tautoenc.AutoNNMF((4, 4), 2, 3, generator=g)(torch.ones(4, 4))
    with pytest.raises(ValueError, match="NNMFLinear"):
        tautoenc.DenseBlock(4, 4, nnmf=True, generator=g)(torch.ones(2, 5))
    ae = tae.build_ae(ae_type="heads", seq_len=T, ffn_features=FFN,
                      heads=HEADS, nnmf=True, generator=g)
    with pytest.raises(ValueError, match="NNMF layer"):
        ae(torch.ones(2, 1, T, FFN // HEADS))


# -- the AE mixers -----------------------------------------------------------

def _mixer_case(jcls, tcls, jkw, tkw, mask_type, x):
    """(JAX's output, its intermediates and grads, the port module, its
    output), the random mask's noise injected."""
    jmod = jcls(features=FEAT, seq_len=T, ffn_features=FFN, **jkw)
    tmod = tcls(FEAT, T, FFN, generator=_g(), **tkw)
    if mask_type == "random":
        tmod.mask_noise = _jax_noise(FFN // 2 if jkw.get("chunk") else FFN)
    (want, state), want_g = _jax_run(jmod, flax_from_state_dict(tmod), x,
                                     mutable=["intermediates"])
    got = tmod(torch.from_numpy(x))
    return want, state["intermediates"], want_g, tmod, got


def _check_mixer(want, inter, want_g, tmod, got, grad_names):
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)
    for name in ("ae_input", "ae_output", "ae_hidden"):
        np.testing.assert_allclose(_np(getattr(tmod, name)),
                                   _np(inter[name][0]), **F32_TOL,
                                   err_msg=name)
    got_g = _grads_by_name(tmod, got)
    for name, g in want_g.items():
        if name.split(".")[0] in grad_names:
            np.testing.assert_allclose(_np(got_g[name]), _np(g), **F32_TOL,
                                       err_msg=name)
        else:  # detached: no path on either side
            assert got_g[name] is None and not np.any(_np(g)), name


AE_TYPES = {"simple": {}, "transpose": {}, "2d_fsfs": {"order_2d": "fsfs"},
            "2d_sffs": {"order_2d": "sffs"}, "2d_sfsf": {"order_2d": "sfsf"},
            "legacy_heads": {"legacy_heads": True}}


# every AE type with the zeros mask with and without --chunk, and with the
# random mask; the random mask and --chunk together once
AE_CASES = ([(ae, "zeros", c) for ae in AE_TYPES for c in (False, True)]
            + [(ae, "random", False) for ae in AE_TYPES]
            + [("simple", "random", True)])


@pytest.mark.parametrize("ae,mask_type,chunk", AE_CASES, ids=[
    f"{a}-{m}-{'chunk' if c else 'whole'}" for a, m, c in AE_CASES])
def test_ae_attention_matches_jax(ae, mask_type, chunk):
    ae_type = {"legacy_heads": "heads"}.get(ae, ae.split("_")[0])
    kw = dict(head=HEADS, ae_type=ae_type, mask_type=mask_type, chunk=chunk,
              ae_hidden_features=6, ae_hidden_seq_len=5, **AE_TYPES[ae])
    x = _x(2, (B, T, FEAT))
    case = _mixer_case(jae.AEAttention, tae.AEAttention, kw, kw, mask_type, x)
    _check_mixer(*case, {"U", "V"})


@pytest.mark.parametrize("mask_type,mask_chunk", [
    ("zeros", 16), ("zeros", 0), ("random", 16)],
    ids=["zeros_chunked", "zeros_whole", "random"])
@pytest.mark.parametrize("chunk", [False, True], ids=["whole", "chunk"])
def test_ae_attention_heads_matches_jax(chunk, mask_type, mask_chunk):
    # the random mask materializes whatever mask_chunk says
    kw = dict(heads=HEADS, ae_hidden_seq_len=5, mask_type=mask_type,
              chunk=chunk, mask_chunk=mask_chunk)
    x = _x(3, (B, T, FEAT))
    case = _mixer_case(jae.AEAttentionHeads, tae.AEAttentionHeads, kw, kw,
                       mask_type, x)
    # without --chunk, x itself is normalized: norm1 has a gradient path
    _check_mixer(*case, {"U", "V"} if chunk else {"U", "V", "norm1"})


def _raise_norm1_bias(tmod):
    """+4 on norm1's bias: the AE's input, LayerNormed, becomes positive.
    An NNMF layer L1-normalizes its input as it is, and on a signed one
    its iterate is ill-conditioned (JAX's own outputs move by far more
    than the f32 limits when the input moves by one ulp), so the mixers of
    NNMF AEs are compared from there."""
    with torch.no_grad():
        tmod.norm1.bias += 4.0
    return tmod


NNMF_AE_CASES = [("simple", "zeros"), ("simple", "random"),
                 ("transpose", "zeros"), ("2d_sffs", "zeros"),
                 ("legacy_heads", "random")]


@pytest.mark.parametrize("ae,mask_type", NNMF_AE_CASES,
                         ids=[f"{a}-{m}" for a, m in NNMF_AE_CASES])
def test_ae_attention_of_nnmf_layers_matches_jax(ae, mask_type):
    ae_type = {"legacy_heads": "heads"}.get(ae, ae.split("_")[0])
    kw = dict(head=HEADS, ae_type=ae_type, mask_type=mask_type,
              ae_hidden_features=6, ae_hidden_seq_len=5,
              use_nnmf_layers=True, **AE_TYPES[ae])
    tmod = _raise_norm1_bias(tae.AEAttention(FEAT, T, FFN, generator=_g(),
                                             **kw))
    x = _x(2, (B, T, FEAT))
    jmod = jae.AEAttention(features=FEAT, seq_len=T, ffn_features=FFN, **kw)
    if mask_type == "random":
        tmod.mask_noise = _jax_noise(FFN)
    (want, state), want_g = _jax_run(jmod, flax_from_state_dict(tmod), x,
                                     mutable=["intermediates"])
    got = tmod(torch.from_numpy(x))
    assert bool((tmod.ae_input > 0).all())
    _check_mixer(want, state["intermediates"], want_g, tmod, got, {"U", "V"})


@pytest.mark.parametrize("mask_type,mask_chunk", [
    ("zeros", 16), ("zeros", 0), ("random", 16)],
    ids=["zeros_chunked", "zeros_whole", "random"])
@pytest.mark.parametrize("chunk", [False, True], ids=["whole", "chunk"])
def test_ae_attention_heads_of_nnmf_layers_matches_jax(chunk, mask_type,
                                                      mask_chunk):
    """The heads AE as one AutoNNMFLayer over (B, 1, heads*T, F/heads),
    its code kept as ``ae_hidden``, and the W.W^T shortcut over the masked
    rows on both the chunked and the materializing path."""
    kw = dict(heads=HEADS, ae_hidden_seq_len=5, mask_type=mask_type,
              chunk=chunk, mask_chunk=mask_chunk, use_nnmf_layers=True)
    tmod = _raise_norm1_bias(tae.AEAttentionHeads(FEAT, T, FFN,
                                                  generator=_g(), **kw))
    assert isinstance(tmod.AE, AutoNNMFLayer)
    if mask_type == "random":
        tmod.mask_noise = _jax_noise(FFN // 2 if chunk else FFN)
    jmod = jae.AEAttentionHeads(features=FEAT, seq_len=T, ffn_features=FFN,
                                **kw)
    x = _x(3, (B, T, FEAT))
    (want, state), want_g = _jax_run(jmod, flax_from_state_dict(tmod), x,
                                     mutable=["intermediates"])
    got = tmod(torch.from_numpy(x))
    inter = dict(state["intermediates"])
    inter["ae_hidden"] = inter["AE"]["hidden_activity"]
    assert tmod.ae_input.shape == (B, 1, HEADS * T, tmod.ae_input.shape[-1])
    _check_mixer(want, inter, want_g, tmod, got,
                 {"U", "V"} if chunk else {"U", "V", "norm1"})


def test_heads_chunked_path_equals_the_materializing_one():
    """mask_chunk rows at a time (16, then 1 at T=17) against the whole
    eye-masked tensor, on the port's side alone."""
    x = torch.from_numpy(_x(4, (B, T, FEAT)))
    mods = [tae.AEAttentionHeads(FEAT, T, FFN, heads=HEADS, mask_chunk=mc,
                                 save_attn_map=True, generator=_g())
            for mc in (16, 0)]
    with torch.no_grad():
        outs = [m(x) for m in mods]
    torch.testing.assert_close(outs[0], outs[1], **F32_TOL)
    torch.testing.assert_close(mods[0].attn_map, mods[1].attn_map, **F32_TOL)


def test_baseline_ae_attention_matches_jax():
    """The softmax is not detached: every parameter has a gradient."""
    x = _x(5, (B, T, FEAT))
    jmod = jae.BaselineAEAttention(features=FEAT, seq_len=T,
                                   ffn_features=FFN, ae_hidden_features=6)
    tmod = tae.BaselineAEAttention(FEAT, T, FFN, ae_hidden_features=6,
                                   generator=_g())
    want, want_g = _jax_run(jmod, flax_from_state_dict(tmod), x)
    got = tmod(torch.from_numpy(x))
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)
    got_g = _grads_by_name(tmod, got)
    assert set(got_g) == set(want_g)
    for name, g in want_g.items():
        assert got_g[name] is not None, name
        np.testing.assert_allclose(_np(got_g[name]), _np(g), **F32_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("cls", ["AEAttention", "AEAttentionHeads",
                                 "BaselineAEAttention"])
def test_save_attn_map_keeps_the_map(cls):
    x = _x(6, (B, T, FEAT))
    kw = {"AEAttentionHeads": dict(heads=HEADS)}.get(cls, {})
    jmod = getattr(jae, cls)(features=FEAT, seq_len=T, ffn_features=FFN,
                             save_attn_map=True, **kw)
    tmod = getattr(tae, cls)(FEAT, T, FFN, save_attn_map=True,
                             generator=_g(), **kw)
    _, state = jax.jit(lambda p: jmod.apply(
        {"params": p}, jnp.asarray(x), mutable=["intermediates"]))(
            flax_from_state_dict(tmod))
    with torch.no_grad():
        tmod(torch.from_numpy(x))
    np.testing.assert_allclose(_np(tmod.attn_map),
                               _np(state["intermediates"]["attn_map"][0]),
                               **F32_TOL)


def test_random_mask_draws_from_the_generator():
    """In training the noise comes from the step's generator; without one
    it is a fixed draw, as JAX's PRNGKey(0) fallback is."""
    x = torch.from_numpy(_x(7, (B, T, FEAT)))
    mod = tae.AEAttention(FEAT, T, FFN, ae_type="transpose",
                          mask_type="random", generator=_g())
    with torch.no_grad():
        a = mod(x, deterministic=False,
                generator=torch.Generator().manual_seed(1))
        b = mod(x, deterministic=False,
                generator=torch.Generator().manual_seed(2))
        c, d = mod(x), mod(x)
        e = mod(x, generator=torch.Generator().manual_seed(0))
    assert not torch.equal(a, b)
    assert torch.equal(c, d) and torch.equal(c, e)


def test_layer_outputs_hold_the_ae_tensors():
    """The histograms' probe forward captures the AE's reconstruction and
    hidden activity (its first call) and the tensors the mixer keeps."""
    x = torch.from_numpy(_x(8, (B, T, FEAT)))
    mod = tae.AEAttention(FEAT, T, FFN, generator=_g())
    outs = get_layer_outputs(mod, x)
    with torch.no_grad():
        want = mod.AE(mod.ae_input)
    torch.testing.assert_close(outs["AE"], want[0], rtol=0, atol=0)
    torch.testing.assert_close(outs["AE.1"], want[1], rtol=0, atol=0)
    for key in ("ae_input", "ae_output", "ae_hidden"):
        assert torch.equal(outs[key], getattr(mod, key)), key
