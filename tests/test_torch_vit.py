"""The port's ViT, its parts and its factory against the JAX package, on
the CPU.

Inputs are made with numpy from a seed; weights are the JAX init carried
across with ``state_dict_from_flax``.  f32 tolerances (rtol 1e-4, atol
1e-5) cover the order of sums; the bf16-mixed comparison allows 2e-2, a few
bf16 rounding steps (2**-7 relative) at logits of order 1, since the two
frameworks round to bf16 at different places through the layers.
"""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vit_cifar_torch.config as tconfig
import vit_cifar_tpu.config as jconfig
from vit_cifar_torch.data.augment import normalize
from vit_cifar_torch.models import get_model
from vit_cifar_torch.models.vit import ViT
from vit_cifar_torch.ops.attention import MultiHeadSelfAttention
from vit_cifar_torch.ops.common import EncoderBlock
from vit_cifar_torch.ops.patchify import from_words, to_words
from vit_cifar_torch.train.steps import make_metrics_zeros
from vit_cifar_torch.utils.transplant import (flax_from_state_dict,
                                              state_dict_from_flax)
from vit_cifar_tpu.data.augment import normalize as jax_normalize
from vit_cifar_tpu.models import get_model as jax_get_model
from vit_cifar_tpu.ops.attention import \
    MultiHeadSelfAttention as JaxMultiHeadSelfAttention
from vit_cifar_tpu.ops.common import EncoderBlock as JaxEncoderBlock
from vit_cifar_tpu.ops.patchify import to_words as jax_to_words
from test_torch_nnmf import one_torch_thread  # noqa: F401 (autouse)

F32_TOL = dict(rtol=1e-4, atol=1e-5)
TINY = dict(model_name="vit", num_layers=2, hidden=32, mlp_hidden=32, head=4)
FLAGSHIP = dict(model_name="vit", num_layers=7, hidden=384, mlp_hidden=384,
                head=12)


def _images(seed, B):
    return np.random.default_rng(seed).integers(0, 256, (B, 32, 32, 3),
                                                dtype=np.uint8)


def _pair(seed=0, **cfg_kw):
    """The JAX model with its init and the port's model holding the same
    weights, for one config."""
    jcfg = jconfig.Config(**cfg_kw)
    jmodel, _ = jax_get_model(jcfg)
    params = jmodel.init(jax.random.PRNGKey(seed),
                         jnp.zeros((1, 32, 32, 3), jnp.float32))["params"]
    tmodel, _ = get_model(tconfig.Config(**cfg_kw), device="cpu")
    tmodel.load_state_dict(state_dict_from_flax(params))
    return jcfg, jmodel, params, tmodel


def _logits(jcfg, jmodel, params, tmodel, imgs):
    x = jax_normalize(jnp.asarray(imgs), jcfg.mean, jcfg.std).astype(
        jcfg.compute_dtype)
    want = np.asarray(jmodel.apply({"params": params}, x, deterministic=True),
                      np.float32)
    with torch.no_grad():
        got = tmodel(normalize(torch.from_numpy(imgs), jcfg.mean, jcfg.std))
    return got.to(torch.float32).numpy(), want


def test_to_words_from_words_match_jax():
    x = np.random.default_rng(0).normal(size=(2, 32, 32, 3)).astype(np.float32)
    got = to_words(torch.from_numpy(x), 8)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jax_to_words(jnp.asarray(x), 8)))
    assert got.shape == (2, 64, 48)
    np.testing.assert_array_equal(from_words(got, 8, 32, 3).numpy(), x)


def test_normalize_matches_jax():
    imgs = _images(1, 4)
    mean, std = jconfig.DATASET_INFO["c10"]["mean"], jconfig.DATASET_INFO["c10"]["std"]
    got = normalize(torch.from_numpy(imgs), mean, std)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jax_normalize(jnp.asarray(imgs), mean, std)),
        rtol=1e-6, atol=1e-6)


def test_encoder_block_matches_jax():
    x = np.random.default_rng(2).normal(size=(2, 9, 32)).astype(np.float32)
    jblock = JaxEncoderBlock(features=32, mlp_hidden=48, mixer=functools.partial(
        JaxMultiHeadSelfAttention, features=32, head=4))
    params = jblock.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    g = torch.Generator().manual_seed(0)
    block = EncoderBlock(32, 48, functools.partial(MultiHeadSelfAttention, 32,
                                                   4, generator=g),
                         generator=g)
    block.load_state_dict(state_dict_from_flax(params))
    want = np.asarray(jblock.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = block(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **F32_TOL)


@pytest.mark.parametrize("kw", [{}, dict(is_cls_token=False),
                                dict(use_encoder_mlp=False)],
                         ids=["cls", "meanpool", "no_mlp"])
def test_vit_logits_match_jax_f32(kw):
    pair = _pair(**TINY, precision="32", **kw)
    got, want = _logits(*pair, _images(3, 4))
    assert got.shape == (4, 10)
    np.testing.assert_allclose(got, want, **F32_TOL)


def test_vit_logits_match_jax_bf16_fused():
    """bf16-mixed: the port's kernel path against the JAX fused kernel."""
    pair = _pair(**TINY, precision="bf16-mixed", pallas_kernel="fused")
    got, want = _logits(*pair, _images(4, 4))
    assert pair[3].emb.weight.dtype == torch.float32  # params stay f32
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)


def test_flagship_width_logits_match_jax_f32():
    pair = _pair(**FLAGSHIP, precision="32")
    got, want = _logits(*pair, _images(5, 2))
    np.testing.assert_allclose(got, want, **F32_TOL)


def test_state_dict_round_trip_and_param_count():
    _, _, params, tmodel = _pair(**FLAGSHIP)
    sd = tmodel.state_dict()
    assert sum(v.numel() for v in sd.values()) == 6_268_810
    assert len(sd) == 120
    back = flax_from_state_dict(tmodel, sd)
    flat = jax.tree_util.tree_leaves_with_path(params)
    assert len(flat) == 120
    for path, leaf in flat:
        node = back
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node, np.asarray(leaf))


@pytest.mark.parametrize("name", ["no_such_model"])
def test_get_model_raises_for_models_not_ported(name):
    with pytest.raises(NotImplementedError):
        get_model(tconfig.Config(model_name=name), device="cpu")


@pytest.mark.parametrize("kw", [dict(seq_pad=1),
                                dict(act_constraint=lambda h: h)],
                         ids=["seq_pad", "act_constraint"])
def test_vit_options_not_ported_raise(kw):
    """``seq_pad`` is ported: ``ViT(seq_pad=3)`` appends 3 zero tokens after
    ``pos_emb`` (unmasked, as in JAX) and its logits are JAX's
    ``ViT(seq_pad=3)``'s.  ``act_constraint``, a GSPMD layout hint, has no
    counterpart (the ``seq_axis`` hook does its work): the argument does
    not exist."""
    g = torch.Generator()
    mixer = functools.partial(MultiHeadSelfAttention, 32, 4, generator=g)
    if "act_constraint" in kw:
        with pytest.raises(TypeError, match="act_constraint"):
            ViT(mixer, num_layers=1, hidden=32, mlp_hidden=32, generator=g,
                **kw)
        return
    jcfg, jmodel, params, tmodel = _pair(**TINY, precision="32")
    jpad = jmodel.clone(seq_pad=3)
    tmodel.seq_pad = 3
    img = _images(0, 4)
    want = jpad.apply({"params": params},
                      jax_normalize(jnp.asarray(img), jcfg.mean, jcfg.std))
    x = normalize(torch.from_numpy(img), jcfg.mean, jcfg.std)
    with torch.no_grad():
        got = tmodel(x)
        plain = ViT(mixer, num_layers=1, hidden=32, mlp_hidden=32,
                    generator=g, **kw)
    assert plain.seq_pad == 1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def test_get_model_is_seeded():
    cfg = tconfig.Config(**TINY)
    a = get_model(cfg, device="cpu")[0].state_dict()
    b = get_model(cfg, device="cpu",
                  generator=torch.Generator().manual_seed(cfg.seed))[0]
    c = get_model(cfg.replace(seed=cfg.seed + 1), device="cpu")[0].state_dict()
    for key, val in b.state_dict().items():
        torch.testing.assert_close(val, a[key], rtol=0, atol=0)
    assert not torch.equal(a["emb.weight"], c["emb.weight"])


@pytest.mark.parametrize("make", ["get_model", "make_metrics_zeros"])
def test_port_entry_points_default_to_the_card(make):
    """``get_model`` and ``make_metrics_zeros`` build on the CUDA card
    unless the caller asks for the CPU; without a card the default raises
    and ``device="cpu"`` builds."""
    cfg = tconfig.Config(**TINY)

    def tensors(**kw):
        if make == "get_model":
            return list(get_model(cfg, **kw)[0].parameters())
        return list(make_metrics_zeros(cfg, **kw).values())

    assert {t.device.type for t in tensors(device="cpu")} == {"cpu"}
    if torch.cuda.is_available():
        assert {t.device.type for t in tensors()} == {"cuda"}
    else:
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            tensors()


def test_config_matches_jax_config():
    """The port's Config is field for field the JAX package's, and their
    JSON is interchangeable."""
    def fields(cls):
        return [(f.name, f.default) for f in dataclasses.fields(cls)]

    assert fields(tconfig.Config) == fields(jconfig.Config)
    assert tconfig.DATASET_INFO == jconfig.DATASET_INFO
    assert tconfig.MODEL_NAMES == jconfig.MODEL_NAMES
    jcfg = jconfig.Config(**FLAGSHIP, mesh_shape=(2,), precision="32")
    tcfg = tconfig.Config.from_json(jcfg.to_json())
    assert tcfg.to_json() == jcfg.to_json()
    assert jconfig.Config.from_json(tcfg.to_json()) == jcfg
    assert json.loads(tcfg.to_json())["mesh_shape"] == [2]
    assert tconfig.torch_dtype(tcfg) == torch.float32
    assert tconfig.torch_dtype(tconfig.Config()) == torch.bfloat16
