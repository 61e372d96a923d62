"""The port's AutoAugment (``vit_cifar_torch/data/autoaugment.py``),
RandomCropPaste and the per-epoch dataset pass (``data/augment.py``)
against the JAX package and PIL, on the CPU.

The port's ops take the JAX package's draws: per image its magnitude and
the sign ``bernoulli(k_op)`` of the key the JAX op would use, and for a
batch the sub-policy index, gate uniforms and signs of JAX's own key splits
(``autoaugment_batch``: ``k_sub``/``k_rest``, then per image and stage
``k, k_gate, k_op``).  Tolerances, each with its reason:

* photometric ops and translate: exact against JAX's ops run op by op
  (integer lut, blend and gather arithmetic written in the same f32
  order).  Compiled, as in JAX's dataset pass, XLA fuses a blend's
  multiply and add and rounds some ties one level apart: against
  ``augment_dataset`` at most 0.2% of the values may differ;
* shear and rotate: JAX applies the shear's four cubic taps as a one-hot
  matrix product and the port as four gathers, so the sums may round one
  level apart at a tie of ``floor(v + 0.5)``; rotate floors coordinates
  from ``cos``/``sin``, whose last bit may differ between libraries and
  move a pixel at a tie.  Limit: values differ on at most 0.2% of a
  batch's entries, by one level for shear.  Measured on the CPU: none
  differ;
* against PIL, the JAX package's own limits (``tests/test_autoaugment.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image, ImageEnhance, ImageOps

from vit_cifar_torch.data import augment as taug
from vit_cifar_torch.data import autoaugment as ta
from vit_cifar_tpu.data import augment as jaug
from vit_cifar_tpu.data import autoaugment as ja
from test_torch_nnmf import one_torch_thread  # noqa: F401 (autouse)

GEOMETRIC = ("shearX", "shearY", "rotate")
# share of a batch's values that may differ where a geometric op ran
GEOMETRIC_SHARE = 2e-3
# share of values that may differ from JAX's compiled dataset pass
# (measured: 0.07-0.08% at 100 images)
COMPILED_SHARE = 2e-3


def _imgs(seed, n=10):
    return np.random.default_rng(seed).integers(0, 256, (n, 32, 32, 3),
                                                dtype=np.uint8)


def _op(name):
    return ta._OP_FNS[ta._OP_ID[name]]


def _jax_sign(keys):
    """The sign JAX's op draws from each image's key."""
    return np.where(np.asarray(jax.vmap(jax.random.bernoulli)(keys)), 1.0,
                    -1.0).astype(np.float32)


def _assert_geometric_close(got, want, shear: bool):
    if got.size == 0:
        return
    diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
    assert (diff > 0).mean() <= GEOMETRIC_SHARE, (diff > 0).mean()
    if shear:
        assert diff.max() <= 1


@pytest.mark.parametrize("name", ja._OP_NAMES)
def test_each_op_matches_jax_over_its_grid(name):
    """Each op at every magnitude of its grid (one image each), with the
    sign JAX's op draws, for two keys per image."""
    imgs = _imgs(ja._OP_ID[name])
    mags = np.asarray(ja._RANGES[name], np.float32)
    fn_j = ja._OP_FNS[ja._OP_ID[name]]
    for seed in range(2):
        keys = jax.random.split(jax.random.PRNGKey(seed), len(imgs))
        want = np.asarray(jax.vmap(fn_j)(jnp.asarray(imgs, jnp.float32),
                                         jnp.asarray(mags), keys))
        got = _op(name)(torch.from_numpy(imgs).float(),
                        torch.from_numpy(mags),
                        torch.from_numpy(_jax_sign(keys))).numpy()
        assert got.dtype == np.float32 and got.shape == imgs.shape
        if name in GEOMETRIC:
            _assert_geometric_close(got, want, shear=name != "rotate")
        else:
            np.testing.assert_array_equal(got, want, err_msg=f"key {seed}")


def test_policy_tables_equal_jax():
    assert ta._OP_NAMES == ja._OP_NAMES
    assert [f.__name__ for f in ta._OP_FNS] == [f.__name__
                                                for f in ja._OP_FNS]
    assert ta._RANGES.keys() == ja._RANGES.keys()
    for k in ja._RANGES:
        np.testing.assert_array_equal(np.asarray(ta._RANGES[k]),
                                      np.asarray(ja._RANGES[k]), err_msg=k)
    assert ta._POLICIES == ja._POLICIES
    assert (len(ta.IMAGENET_POLICY), len(ta.CIFAR10_POLICY),
            len(ta.SVHN_POLICY)) == (25, 24, 25)
    for ds in ("c10", "c100", "svhn"):
        assert ta.policy_for_dataset(ds) == ja.policy_for_dataset(ds)


def _jax_draws(key, batch: int, policy: str):
    """autoaugment_batch's draws, from its own key splits, as torch
    tensors: (sub, gate_u, sign)."""
    k_sub, k_rest = jax.random.split(key)
    sub = jax.random.randint(k_sub, (batch,), 0, len(ja._POLICIES[policy]))

    def stages(k):
        gates, signs = [], []
        for _ in range(2):
            k, k_gate, k_op = jax.random.split(k, 3)
            gates.append(jax.random.uniform(k_gate))
            signs.append(jax.random.bernoulli(k_op))
        return jnp.stack(gates), jnp.stack(signs)

    gate_u, sign = jax.vmap(stages)(jax.random.split(k_rest, batch))
    return (torch.from_numpy(np.array(sub, np.int64)),
            torch.from_numpy(np.array(gate_u)),
            torch.from_numpy(np.array(sign)))


def _geometric_images(sub, gate_u, policy):
    """The images in which a geometric op ran."""
    subs = ja._POLICIES[policy]
    return np.array([any(gate_u[b, s] < subs[i][s][0]
                         and subs[i][s][1] in GEOMETRIC for s in range(2))
                     for b, i in enumerate(sub.tolist())])


@pytest.mark.parametrize("seed,policy", enumerate(["cifar10", "svhn",
                                                    "imagenet"]))
def test_apply_autoaugment_matches_jax_batch(seed, policy):
    imgs = _imgs(10 + seed, 16)
    key = jax.random.PRNGKey(seed)
    want = np.asarray(ja.autoaugment_batch(key, jnp.asarray(imgs), policy))
    draws = _jax_draws(key, 16, policy)
    got = ta.apply_autoaugment(torch.from_numpy(imgs), *draws, policy)
    assert got.dtype == torch.uint8
    got = got.numpy()
    geo = _geometric_images(draws[0], draws[1].numpy(), policy)
    np.testing.assert_array_equal(got[~geo], want[~geo])
    _assert_geometric_close(got[geo], want[geo], shear=True)
    assert not np.array_equal(got, imgs)


def test_autoaugment_batch_is_its_draws_then_apply():
    imgs = torch.from_numpy(_imgs(3, 64))
    gen = torch.Generator().manual_seed(5)
    state = gen.get_state()
    out = ta.autoaugment_batch(gen, imgs, "cifar10")
    gen.set_state(state)
    sub, gate_u, sign = ta.autoaugment_draws(gen, 64, "cifar10")
    assert torch.equal(out, ta.apply_autoaugment(imgs, sub, gate_u, sign,
                                                 "cifar10"))
    assert sub.dtype == torch.int64 and 0 <= sub.min() and sub.max() < 24
    assert gate_u.shape == sign.shape == (64, 2) and sign.dtype == torch.bool
    assert 0.0 <= gate_u.min() and gate_u.max() < 1.0


# -- the exact photometric ops against PIL ---------------------------------

def _one(name, img, mag, sign=1.0):
    out = _op(name)(torch.from_numpy(img[None]).float(),
                    torch.tensor([mag], dtype=torch.float32),
                    torch.tensor([sign]))
    return np.clip(out[0].numpy(), 0, 255).astype(np.uint8)


def test_invert_solarize_posterize_equalize_match_pil():
    img = _imgs(20, 1)[0]
    pil = Image.fromarray(img)
    np.testing.assert_array_equal(_one("invert", img, 0.0),
                                  np.asarray(ImageOps.invert(pil)))
    for thr in (0.0, 77.0, 128.0, 256.0):
        np.testing.assert_array_equal(_one("solarize", img, thr),
                                      np.asarray(ImageOps.solarize(pil, thr)))
    for bits in (4, 5, 6, 7, 8):
        np.testing.assert_array_equal(
            _one("posterize", img, float(bits)),
            np.asarray(ImageOps.posterize(pil, bits)))
    np.testing.assert_array_equal(_one("equalize", img, 0.0),
                                  np.asarray(ImageOps.equalize(pil)))
    flat = np.full((32, 32, 3), 7, np.uint8)  # one nonzero bin: identity
    np.testing.assert_array_equal(
        _one("equalize", flat, 0.0),
        np.asarray(ImageOps.equalize(Image.fromarray(flat))))


def test_autocontrast_matches_pil():
    img = (_imgs(21, 1)[0] // 2 + 40).astype(np.uint8)
    diff = np.abs(_one("autocontrast", img, 0.0).astype(int) - np.asarray(
        ImageOps.autocontrast(Image.fromarray(img))).astype(int))
    assert diff.max() <= 1  # PIL's lut rounding, in rare bins


@pytest.mark.parametrize("name,enhancer", [
    ("brightness", ImageEnhance.Brightness), ("color", ImageEnhance.Color),
    ("contrast", ImageEnhance.Contrast),
    ("sharpness", ImageEnhance.Sharpness)])
def test_enhance_ops_match_pil(name, enhancer):
    img = _imgs(22, 1)[0]
    for sign in (1.0, -1.0):
        want = np.asarray(enhancer(Image.fromarray(img)).enhance(
            1 + 0.5 * sign)).astype(int)
        assert np.abs(_one(name, img, 0.5, sign).astype(int)
                      - want).max() <= 2, sign


def test_translate_matches_pil_exactly():
    img = _imgs(23, 1)[0]
    for sign in (1.0, -1.0):
        want = Image.fromarray(img).transform(
            (32, 32), Image.AFFINE, (1, 0, 0.3 * 32 * sign, 0, 1, 0),
            fillcolor=(128, 128, 128))
        np.testing.assert_array_equal(_one("translateX", img, 0.3, sign),
                                      np.asarray(want))


# -- RandomCropPaste and the dataset pass -----------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_crop_paste_matches_jax(seed):
    x = np.random.default_rng(seed).normal(size=(12, 32, 32, 3)).astype(
        np.float32)
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jaug.random_crop_paste(key, jnp.asarray(x)))
    ks = jax.random.split(key, 7)
    B = 12
    draws = (jax.random.beta(ks[0], 1.0, 1.0, (B,)),
             jax.random.randint(ks[1], (B,), 0, 32),
             jax.random.randint(ks[2], (B,), 0, 32),
             jax.random.uniform(ks[3], (B,)),
             jax.random.uniform(ks[4], (B,)),
             jax.random.uniform(ks[5], (B,)) <= 0.5,
             jax.random.uniform(ks[6], (B, 1))[:, 0] <= 0.5,
             jax.random.uniform(jax.random.fold_in(key, 1),
                                (B, 1, 1, 1)).reshape(B))
    got = taug.apply_crop_paste(torch.from_numpy(x),
                                *(torch.from_numpy(np.array(d))
                                  for d in draws))
    np.testing.assert_array_equal(got.numpy(), want)
    assert not np.array_equal(want, x)


def test_crop_paste_draws_cover_their_ranges():
    lam, cx, cy, u_px, u_py, ff, fb, mix = taug.crop_paste_draws(
        torch.Generator().manual_seed(0), 4000, 32)
    for u in (lam, u_px, u_py, mix):
        assert u.dtype == torch.float32 and 0 <= u.min() and u.max() < 1
    for c in (cx, cy):
        assert c.min() == 0 and c.max() == 31
    for f in (ff, fb):
        assert f.dtype == torch.bool and 0.45 < f.float().mean() < 0.55


@pytest.mark.parametrize("chunk", [2500, 40], ids=["one_chunk", "boundary"])
def test_augment_dataset_matches_jax(chunk):
    """100 images in one chunk, and in chunks of 40 (the last one short;
    JAX pads it to 40 by cycling images and drops the pad)."""
    n = 100
    xs = _imgs(30, n)
    key = jax.random.PRNGKey(4)
    want = np.asarray(jaug.augment_dataset(
        key, jnp.asarray(xs.reshape(n, -1)), (32, 32, 3), 4,
        autoaugment_policy="cifar10", chunk=chunk)).reshape(xs.shape)
    k_crop, k_aa = jax.random.split(key)
    k_y, k_x, k_f = jax.random.split(k_crop, 3)
    crop = tuple(torch.from_numpy(np.array(a)) for a in (
        jax.random.randint(k_y, (n,), 0, 9),
        jax.random.randint(k_x, (n,), 0, 9),
        jax.random.bernoulli(k_f, 0.5, (n,))))
    size = min(chunk, n)
    per_chunk = [_jax_draws(k, size, "cifar10")
                 for k in jax.random.split(k_aa, -(-n // size))]
    aa = tuple(torch.cat(d)[:n] for d in zip(*per_chunk))
    got = taug.apply_augment_dataset(torch.from_numpy(xs), 4, crop, aa,
                                     "cifar10", chunk)
    assert got.dtype == torch.uint8 and got.shape == xs.shape
    # JAX's pass is compiled (``lax.map``): XLA fuses the blends' multiply
    # and add, which rounds some ties one level apart from the op-by-op
    # arithmetic the port shares with JAX's ops, and a second stage may
    # carry such a level further (solarize's threshold, equalize's lut)
    diff = got.numpy() != want
    assert diff.mean() <= COMPILED_SHARE, diff.mean()


def test_augment_dataset_is_its_draws_then_apply():
    xs = torch.from_numpy(_imgs(31, 30))
    gen = torch.Generator().manual_seed(2)
    state = gen.get_state()
    out = taug.augment_dataset(gen, xs, 4, autoaugment_policy="svhn",
                               chunk=16)
    gen.set_state(state)
    crop, aa = taug.augment_dataset_draws(gen, 30, 4,
                                          autoaugment_policy="svhn")
    assert torch.equal(out, taug.apply_augment_dataset(xs, 4, crop, aa,
                                                       "svhn", 16))
    # without a policy: crop and flip only
    gen.set_state(state)
    plain = taug.augment_dataset(gen, xs, 4)
    gen.set_state(state)
    assert torch.equal(plain, taug.random_crop_flip(gen, xs, 4))
