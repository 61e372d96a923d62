"""The port's training slice -- losses, schedule, optimizers, the
non-finite guard, augmentation, datasets, init, and the train and eval
steps -- against the JAX package, on the CPU.

Inputs are made with numpy from a seed; weights are the JAX init carried
across with ``state_dict_from_flax``; random draws are JAX's, handed to the
port's ``apply_*`` functions and to its step's batch seam, since the two
frameworks' random streams never agree.  Tolerances, each with its reason:

* f32 math written the same way on both sides (losses, schedule, optimizer
  updates, augmentation): rtol 1e-6 / atol 1e-7 -- a few f32 ulps, from
  ``exp``/``log``/``cos`` implementations that differ in the last bit;
* a forward and backward of a 2-layer ViT in f32: rtol 1e-4 / atol 1e-5
  (the order of sums differs), as in ``tests/test_torch_vit.py``;
* parameters after Adam steps: atol 1e-4 -- Adam's first update is
  lr * g / (|g| + eps), nearly lr * sign(g), so a gradient element within
  rounding of zero may move its parameter by a visible fraction of
  lr = 1e-3 on one side and not the other.
"""

import functools
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import vit_cifar_torch.config as tconfig
import vit_cifar_tpu.config as jconfig
from vit_cifar_torch.data import augment as taug
from vit_cifar_torch.data.datasets import _synthetic, load_dataset
from vit_cifar_torch.models import get_model
from vit_cifar_torch.ops.common import dropout
from vit_cifar_torch.ops.cuda import KERNEL_WRAPPERS
from vit_cifar_torch.train import losses as tlosses
from vit_cifar_torch.train.loop import _pad_eval, init_state
from vit_cifar_torch.train.optim import (flatten_params, make_optimizer,
                                         warmup_cosine_epoch_schedule)
from vit_cifar_torch.train.steps import (make_eval_step, make_metrics_zeros,
                                         make_train_step)
from vit_cifar_torch.utils.transplant import state_dict_from_flax
from vit_cifar_tpu.data import augment as jaug
from vit_cifar_tpu.data.datasets import _synthetic as jax_synthetic
from vit_cifar_tpu.data.datasets import load_dataset as jax_load_dataset
from vit_cifar_tpu.models import get_model as jax_get_model
from vit_cifar_tpu.train import losses as jlosses
from vit_cifar_tpu.train.loop import _pad_eval as jax_pad_eval
from vit_cifar_tpu.train.loop import init_state as jax_init_state
from vit_cifar_tpu.train.optim import make_optimizer as jax_make_optimizer
from vit_cifar_tpu.train.optim import \
    warmup_cosine_epoch_schedule as jax_schedule
from vit_cifar_tpu.train.steps import make_eval_step as jax_make_eval_step
from vit_cifar_tpu.train.steps import \
    make_grad_debug_step as jax_make_grad_debug_step
from vit_cifar_tpu.train.steps import make_train_step as jax_make_train_step
from test_torch_nnmf import one_torch_thread  # noqa: F401 (autouse)

EXACT = dict(rtol=1e-6, atol=1e-7)
F32_TOL = dict(rtol=1e-4, atol=1e-5)
ADAM_PARAM_TOL = dict(rtol=1e-4, atol=1e-4)
TINY = dict(model_name="vit", num_layers=2, hidden=32, mlp_hidden=32, head=4,
            batch_size=8, eval_batch_size=8, label_smoothing=True,
            warmup_epoch=0, precision="32", dropout=0.0)


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


# -- losses -----------------------------------------------------------------

@pytest.mark.parametrize("classes", [10, 100])
def test_losses_match_jax(classes):
    rng = np.random.default_rng(0)
    logits = (3 * rng.normal(size=(16, classes))).astype(np.float32)
    labels = rng.integers(0, classes, 16).astype(np.int32)
    tl, ty = torch.from_numpy(logits), torch.from_numpy(labels)
    jl, jy = jnp.asarray(logits), jnp.asarray(labels)
    np.testing.assert_allclose(_np(tlosses.cross_entropy(tl, ty)),
                               jlosses.cross_entropy(jl, jy), **EXACT)
    np.testing.assert_allclose(
        _np(tlosses.label_smoothing_cross_entropy(tl, ty, classes, 0.1)),
        jlosses.label_smoothing_cross_entropy(jl, jy, classes, 0.1), **EXACT)
    dataset = "c10" if classes == 10 else "c100"
    for smoothing in (False, True):
        kw = dict(dataset=dataset, label_smoothing=smoothing)
        tc, jc = tconfig.Config(**kw), jconfig.Config(**kw)
        np.testing.assert_allclose(
            _np(tlosses.make_per_example_loss(tc)(tl, ty)),
            jlosses.make_per_example_loss(jc)(jl, jy), **EXACT)
        np.testing.assert_allclose(_np(tlosses.make_criterion(tc)(tl, ty)),
                                   jlosses.make_criterion(jc)(jl, jy),
                                   **EXACT)


def test_label_smoothing_is_not_torchs():
    """s/(C-1) off the target, where torch's label_smoothing= gives s/C."""
    logits = torch.randn(4, 10, generator=torch.Generator().manual_seed(0))
    labels = torch.tensor([0, 3, 5, 9])
    ours = tlosses.label_smoothing_cross_entropy(logits, labels, 10, 0.1)
    torchs = torch.nn.functional.cross_entropy(logits, labels,
                                               label_smoothing=0.1)
    assert not torch.allclose(ours, torchs)


# -- schedule and optimizers ------------------------------------------------

@pytest.mark.parametrize("warmup", [0, 1, 5])
def test_schedule_matches_jax_at_every_epoch_boundary(warmup):
    spe, max_epochs = 7, 12
    args = (1e-3, 1e-5, warmup, max_epochs, spe)
    counts = np.array([c for e in range(max_epochs + 1)
                       for c in (e * spe, e * spe + spe - 1)], np.int32)
    got = warmup_cosine_epoch_schedule(*args)(torch.from_numpy(counts))
    want = jax_schedule(*args)(jnp.asarray(counts))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), np.asarray(want), **EXACT)
    if warmup:  # epochs W and W+1 both at base lr, epoch 0 at lr 0
        assert got[0] == 0.0
        assert got[2 * warmup] == got[2 * (warmup + 1)]
        np.testing.assert_allclose(_np(got[2 * warmup]), 1e-3, **EXACT)


@pytest.mark.parametrize("optimizer", ["adam", "sgd"])
def test_optimizer_matches_optax_on_identical_grads(optimizer):
    cfg_kw = dict(optimizer=optimizer, warmup_epoch=1, max_epochs=4,
                  weight_decay=5e-2)
    spe, n = 2, 6
    rng = np.random.default_rng(1)
    p0 = rng.normal(size=300).astype(np.float32)
    grads = [rng.normal(size=300).astype(np.float32) for _ in range(n)]

    jtx = jax_make_optimizer(jconfig.Config(**cfg_kw), spe)
    jp, jstate = {"w": jnp.asarray(p0)}, None
    jstate = jtx.init(jp)
    ttx = make_optimizer(tconfig.Config(**cfg_kw), spe)
    tp = torch.from_numpy(p0.copy())
    tstate = ttx.init(tp)
    for g in grads:
        ju, jstate = jtx.update({"w": jnp.asarray(g)}, jstate, jp)
        jp = optax.apply_updates(jp, ju)
        tu, tstate = ttx.update(torch.from_numpy(g), tstate, tp)
        tp = tp + tu
        np.testing.assert_allclose(_np(tu), np.asarray(ju["w"]), **EXACT)
    np.testing.assert_allclose(_np(tp), np.asarray(jp["w"]), **EXACT)
    inner = jstate  # flatten_transform keeps the inner chain's state
    if optimizer == "adam":
        np.testing.assert_allclose(_np(tstate["mu"]), inner[1].mu, **EXACT)
        np.testing.assert_allclose(_np(tstate["nu"]), inner[1].nu, **EXACT)
    else:
        np.testing.assert_allclose(_np(tstate["trace"]), inner[1].trace,
                                   **EXACT)
    assert int(tstate["count"]) == int(inner[2].count) == n


def test_flatten_params_makes_parameters_views():
    model, _ = get_model(tconfig.Config(**TINY), device="cpu")
    before = [p.detach().clone() for p in model.parameters()]
    flat = flatten_params(model)
    assert flat.numel() == sum(p.numel() for p in model.parameters())
    for p, b in zip(model.parameters(), before):
        torch.testing.assert_close(p.detach(), b, rtol=0, atol=0)
    with torch.no_grad():
        flat.add_(1.0)
    for p, b in zip(model.parameters(), before):
        torch.testing.assert_close(p.detach(), b + 1.0, rtol=0, atol=0)


# -- dropout ----------------------------------------------------------------

def test_dropout_in_training_follows_flax():
    x = torch.randn(64, 256, generator=torch.Generator().manual_seed(0))
    assert dropout(x, 0.0, False) is x  # the recipe's rate: exactly x
    assert dropout(x, 0.3, True) is x
    gen = torch.Generator().manual_seed(1)
    y = dropout(x, 0.25, False, gen)
    kept = y != 0
    torch.testing.assert_close(y[kept], (x / 0.75)[kept], rtol=0, atol=0)
    assert abs(kept.float().mean().item() - 0.75) < 0.01
    again = dropout(x, 0.25, False, torch.Generator().manual_seed(1))
    assert torch.equal(y, again)
    assert torch.equal(dropout(x, 1.0, False, gen), torch.zeros_like(x))
    with pytest.raises(ValueError, match="Generator"):
        dropout(x, 0.25, False)


# -- augmentation with JAX's draws ------------------------------------------

@pytest.mark.parametrize("flip", [True, False], ids=["c10", "svhn"])
def test_random_crop_flip_matches_jax(flip):
    x = np.random.default_rng(2).integers(0, 256, (6, 32, 32, 3), np.uint8)
    key = jax.random.PRNGKey(3)
    want = jaug.random_crop_flip(key, jnp.asarray(x), 4, flip)
    k_y, k_x, k_f = jax.random.split(key, 3)
    off_y = jax.random.randint(k_y, (6,), 0, 9)
    off_x = jax.random.randint(k_x, (6,), 0, 9)
    do = jax.random.bernoulli(k_f, 0.5, (6,)) if flip else None
    got = taug.apply_crop_flip(
        torch.from_numpy(x), 4, torch.from_numpy(np.array(off_y)),
        torch.from_numpy(np.array(off_x)),
        None if do is None else torch.from_numpy(np.array(do)))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_crop_flip_draws_cover_their_ranges():
    off_y, off_x, do = taug.crop_flip_draws(
        torch.Generator().manual_seed(0), 4000, 4)
    for off in (off_y, off_x):
        assert off.min() == 0 and off.max() == 8
    assert 0.45 < do.float().mean() < 0.55
    assert taug.crop_flip_draws(torch.Generator(), 3, 4, flip=False)[2] is None


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cutmix_matches_jax(seed):
    rng = np.random.default_rng(seed)
    img = rng.normal(size=(8, 32, 32, 3)).astype(np.float32)
    label = rng.integers(0, 10, 8).astype(np.int32)
    key = jax.random.PRNGKey(seed)
    want = jaug.cutmix(key, jnp.asarray(img), jnp.asarray(label), 32)
    k_lam, k_x, k_y, k_perm = jax.random.split(key, 4)
    draws = (jax.random.beta(k_lam, 1.0, 1.0),
             jax.random.uniform(k_x, (), minval=0.0, maxval=32),
             jax.random.uniform(k_y, (), minval=0.0, maxval=32),
             jax.random.permutation(k_perm, 8))
    got = taug.apply_cutmix(torch.from_numpy(img), torch.from_numpy(label),
                            32, *(torch.from_numpy(np.array(d))
                                  for d in draws))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), **EXACT)


def test_mixup_matches_jax():
    rng = np.random.default_rng(4)
    img = rng.normal(size=(8, 32, 32, 3)).astype(np.float32)
    label = rng.integers(0, 10, 8).astype(np.int32)
    key = jax.random.PRNGKey(5)
    want = jaug.mixup(key, jnp.asarray(img), jnp.asarray(label))
    k_lam, k_perm = jax.random.split(key)
    lam = jax.random.beta(k_lam, 1.0, 1.0)
    perm = jax.random.permutation(k_perm, 8)
    got = taug.apply_mixup(torch.from_numpy(img), torch.from_numpy(label),
                           torch.from_numpy(np.array(lam)),
                           torch.from_numpy(np.array(perm)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), **EXACT)


# -- datasets ---------------------------------------------------------------

def test_synthetic_c10_is_bit_equal_to_jax():
    got, want = _synthetic("c10"), jax_synthetic("c10")
    for name in ("x_train", "y_train", "x_test", "y_test"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert got.num_classes == 10 and got.synthetic


def _write_cifar(root, dataset: str):
    rng = np.random.default_rng(6)

    def batch(n, label_key, classes):
        return {b"data": rng.integers(0, 256, (n, 3072), dtype=np.uint8),
                label_key: rng.integers(0, classes, n).tolist()}

    if dataset == "c10":
        d = root / "cifar-10-batches-py"
        d.mkdir()
        files = {f"data_batch_{i}": batch(3, b"labels", 10)
                 for i in range(1, 6)}
        files["test_batch"] = batch(4, b"labels", 10)
    else:
        d = root / "cifar-100-python"
        d.mkdir()
        files = {"train": batch(5, b"fine_labels", 100),
                 "test": batch(4, b"fine_labels", 100)}
    for name, content in files.items():
        with open(d / name, "wb") as f:
            pickle.dump(content, f)


@pytest.mark.parametrize("dataset", ["c10", "c100"])
def test_cifar_pickles_read_like_jax(tmp_path, dataset):
    _write_cifar(tmp_path, dataset)
    got = load_dataset(dataset, str(tmp_path))
    want = jax_load_dataset(dataset, str(tmp_path))
    assert not got.synthetic
    assert got.x_train.shape[1:] == (32, 32, 3)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_unknown_dataset_raises():
    with pytest.raises(NotImplementedError):
        load_dataset("imagenet")


# -- train and eval steps against the JAX step ------------------------------

N_TRAIN = 32


@functools.cache
def _jax_side(kernel: str):
    """The JAX config, model, initial state and jitted train and grad steps
    for ``kernel``, built once per module (JAX state is immutable)."""
    jcfg = jconfig.Config(**dict(TINY, pallas_kernel=kernel))
    jmodel, _ = jax_get_model(jcfg)
    jtx = jax_make_optimizer(jcfg, N_TRAIN // jcfg.batch_size)
    jstate = jax_init_state(jcfg, jmodel, jtx,
                            jnp.zeros((2, 32, 32, 3), jnp.float32))
    return (jcfg, jmodel, jstate,
            jax.jit(jax_make_train_step(jcfg, jmodel, jtx)),
            jax.jit(jax_make_grad_debug_step(jcfg, jmodel)))


def _tiny_pair(kernel: str, port_kernel: str | None = None):
    """The JAX side of ``kernel`` and a fresh port state with the JAX init
    transplanted (its attention path ``port_kernel``, default the same), on
    a small uint8 dataset."""
    jside = _jax_side(kernel)
    tcfg = tconfig.Config(**dict(TINY, pallas_kernel=port_kernel or kernel))
    tmodel, _ = get_model(tcfg, device="cpu")
    tmodel.load_state_dict(state_dict_from_flax(jside[2].params))
    ttx = make_optimizer(tcfg, N_TRAIN // tcfg.batch_size)
    tstate = init_state(tcfg, tmodel, ttx)
    rng = np.random.default_rng(7)
    data = (rng.integers(0, 256, (N_TRAIN, 32, 32, 3), dtype=np.uint8),
            rng.integers(0, 10, N_TRAIN).astype(np.int32),
            rng.permutation(N_TRAIN).astype(np.int32))
    return jside, (tcfg, tmodel, ttx, tstate), data


def _jax_batch(jcfg, jstate, x, y, perm, i):
    """The batch the JAX step draws at (state, i): its crop/flip key, then
    normalize and cast -- the seam's input on the port's side."""
    key = jax.random.fold_in(jstate.rng, jstate.step)
    k_crop = jax.random.split(key, 6)[0]
    idx = perm[i * jcfg.batch_size:(i + 1) * jcfg.batch_size]
    img = jaug.random_crop_flip(k_crop, jnp.asarray(x[idx]), jcfg.padding,
                                flip=True)
    img = jaug.normalize(img, jcfg.mean, jcfg.std)
    return (torch.from_numpy(np.array(img, np.float32)),
            torch.from_numpy(y[idx]))


@pytest.mark.parametrize("n_steps", [1, 3])
@pytest.mark.parametrize("kernel", ["fused", "einsum"])
def test_train_steps_match_jax(kernel, n_steps):
    (jcfg, _, jstate, jstep, jgrads), (tcfg, tmodel, ttx, tstate), data = \
        _tiny_pair(kernel)
    x, y, perm = data
    tstep = make_train_step(tcfg, tmodel, ttx)
    crit = tlosses.make_criterion(tcfg)
    jx, jy, jperm = (jnp.asarray(a) for a in data)
    for i in range(n_steps):
        img, label = _jax_batch(jcfg, jstate, x, y, perm, i)
        # gradients at the same pre-step state and batch
        want_g, want_loss = jgrads(jstate, jx, jy, jperm, i)
        params = list(tmodel.parameters())
        loss = crit(tmodel(img, deterministic=False,
                           generator=tstate.generator), label)
        got_g = dict(zip((n for n, _ in tmodel.named_parameters()),
                         torch.autograd.grad(loss, params)))
        for name, g in state_dict_from_flax(want_g).items():
            np.testing.assert_allclose(_np(got_g[name]), _np(g), **F32_TOL,
                                       err_msg=f"grad {name}, step {i}")
        np.testing.assert_allclose(_np(loss), np.asarray(want_loss),
                                   **F32_TOL)
        jstate, jm = jstep(jstate, jx, jy, jperm, i)
        tstate, tm = tstep.on_batch(tstate, img, label)
        for name in ("loss", "acc", "skipped_nonfinite"):
            np.testing.assert_allclose(_np(tm[name]), np.asarray(jm[name]),
                                       **F32_TOL, err_msg=name)
    assert tstate.step == int(jstate.step) == n_steps
    assert int(tstate.opt_state["count"]) == n_steps
    for name, p in state_dict_from_flax(jstate.params).items():
        np.testing.assert_allclose(_np(tmodel.state_dict()[name]), _np(p),
                                   **ADAM_PARAM_TOL, err_msg=name)


def test_nonfinite_guard_leaves_params_moments_and_count():
    _, (tcfg, tmodel, ttx, tstate), (x, y, perm) = _tiny_pair("einsum",
                                                              "fused")
    tstate.metrics_acc = make_metrics_zeros(tcfg, device="cpu")
    tstep = make_train_step(tcfg, tmodel, ttx)
    xt, yt, pt = (torch.from_numpy(a) for a in (x, y, perm))
    tstate, _ = tstep(tstate, xt, yt, pt, 0)  # one applied step first
    before = {k: v.clone() for k, v in tstate.opt_state.items()}
    params = tstate.params.clone()
    img, label = tstep.make_batch(tstate, xt, yt, pt, 1)[:2]
    img[0, 0, 0, 0] = float("nan")
    tstate, m = tstep.on_batch(tstate, img, label)
    assert not torch.isfinite(m["loss"]) and m["skipped_nonfinite"] == 1.0
    assert torch.equal(tstate.params, params)
    for k, v in before.items():
        assert torch.equal(tstate.opt_state[k], v), k
    assert int(tstate.opt_state["count"]) == 1 and tstate.step == 2
    assert tstate.metrics_acc["skipped_nonfinite"] == 1.0
    # the next applied step takes up the count where it stopped
    tstate, m = tstep(tstate, xt, yt, pt, 2)
    assert m["skipped_nonfinite"] == 0.0
    assert int(tstate.opt_state["count"]) == 2
    assert not torch.equal(tstate.params, params)


@pytest.mark.parametrize("mix", ["cutmix", "mixup"])
def test_train_step_with_batch_mixing(mix):
    kw = dict(TINY, **{mix: True})
    tcfg = tconfig.Config(**kw)
    model, _ = get_model(tcfg, device="cpu")
    tx = make_optimizer(tcfg, 4)
    state = init_state(tcfg, model, tx)
    state.metrics_acc = make_metrics_zeros(tcfg, device="cpu")
    step = make_train_step(tcfg, model, tx)
    rng = np.random.default_rng(8)
    xt = torch.from_numpy(rng.integers(0, 256, (32, 32, 32, 3), np.uint8))
    yt = torch.from_numpy(rng.integers(0, 10, 32).astype(np.int32))
    pt = torch.randperm(32, generator=torch.Generator().manual_seed(0))
    img, label, rand_label, lam = step.make_batch(state, xt, yt, pt, 0)
    assert img.shape == (8, 32, 32, 3) and rand_label.shape == (8,)
    assert 0.0 <= float(lam) <= 1.0
    for i in range(4):
        state, m = step(state, xt, yt, pt, i)
        assert torch.isfinite(m["loss"])
    assert torch.isfinite(state.metrics_acc["loss"])
    assert state.metrics_acc["skipped_nonfinite"] == 0.0
    assert int(state.opt_state["count"]) == 4


def test_eval_step_masked_sums_match_jax():
    # the JAX side on its einsum path (its interpret-mode kernel is slow
    # outside jit and numerically interchangeable); the port on its kernel
    (jcfg, jmodel, jstate, _, _), (tcfg, tmodel, _, _), _ = _tiny_pair(
        "einsum", port_kernel="fused")
    rng = np.random.default_rng(9)
    x = rng.integers(0, 256, (13, 32, 32, 3), dtype=np.uint8)
    y = rng.integers(0, 10, 13).astype(np.int32)
    got_pad, want_pad = _pad_eval(x, y, 8), jax_pad_eval(x, y, 8)
    for a, b in zip(got_pad, want_pad):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    xp, yp, mask, steps = got_pad
    assert steps == 2 and mask.sum() == 13
    jeval = jax_make_eval_step(jcfg, jmodel)
    teval = make_eval_step(tcfg, tmodel)
    totals = {"loss_sum": 0.0, "correct_sum": 0.0, "count": 0.0}
    for s in range(steps):
        sl = slice(8 * s, 8 * (s + 1))
        want = jeval(jstate.params, jstate.model_state, jnp.asarray(xp[sl]),
                     jnp.asarray(yp[sl]), jnp.asarray(mask[sl]))
        got = teval(*(torch.from_numpy(a[sl]) for a in (xp, yp, mask)))
        for k in totals:
            np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]),
                                       **F32_TOL, err_msg=k)
            totals[k] += float(got[k])
    assert totals["count"] == 13.0


def test_cpu_training_path_counts_no_launch():
    _, (tcfg, tmodel, ttx, tstate), (x, y, perm) = _tiny_pair("einsum",
                                                              "fused")
    before = {n: w.launches for n, w in KERNEL_WRAPPERS.items()}
    step = make_train_step(tcfg, tmodel, ttx)
    step(tstate, *(torch.from_numpy(a) for a in (x, y, perm)), 0)
    make_eval_step(tcfg, tmodel)(torch.from_numpy(x[:8]),
                                 torch.from_numpy(y[:8]), torch.ones(8))
    assert {n: w.launches for n, w in KERNEL_WRAPPERS.items()} == before


def test_init_state_starts_at_zero():
    tcfg = tconfig.Config(**TINY)
    model, _ = get_model(tcfg, device="cpu")
    state = init_state(tcfg, model, make_optimizer(tcfg, 4))
    assert state.step == 0 and int(state.opt_state["count"]) == 0
    assert state.params.numel() == sum(p.numel() for p in model.parameters())
    assert state.generator.device == state.params.device
    assert all(not torch.any(v) for k, v in state.opt_state.items())
