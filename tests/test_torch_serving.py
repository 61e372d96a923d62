"""The port's serving artifact (``deploy.py``) and the operators it runs, on
the CPU, against the JAX package.

* The kernels and the seed-0 draw are ``torch.library`` operators
  (``ops/cuda/registry.py``): each passes ``torch.library.opcheck``, and the
  wrappers reach them.
* ``serving.pt2`` is ``torch.export`` of the eval path with a symbolic
  batch: one artifact of a 2-layer ViT serves B = 1, 3, 8 with JAX's jitted
  eval path's logits (``_inference_fn``) on the same transplanted weights,
  in f32 (rtol/atol 1e-5, JAX's own export bound); its graph names the
  attention operator; a process that imports only torch and
  ``vit_cifar_torch.ops.cuda`` serves it without the checkpoint.
* ``--quantize int8``: the int8 tensors and scales against JAX's
  ``_quantize_store`` (equal, and 1e-7), the logits against JAX's jitted
  int8 eval path (1e-5), the artifact under 0.6x the f32 one's bytes and
  the same top-1 on 16 images (``tests/test_deploy.py``'s bounds).
* ``pallas_kernel="fused"`` past the whole head's shared memory runs, and
  matches JAX's ``fused_attention`` in interpret mode (f32, rtol 1e-4 /
  atol 1e-5: the same math, sums in another order); past T=1024, where
  JAX's fused VJP gives NaN dk and dv, those match JAX's flash VJP.
* The weight transplant returns arrays that own their memory.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vit_cifar_torch.config as tconfig
from vit_cifar_torch.deploy import (export_inference, export_model,
                                    load_inference, quantize_weights)
from vit_cifar_torch.models import get_model as torch_get_model
from vit_cifar_torch.ops.attention import MultiHeadSelfAttention, route
from vit_cifar_torch.ops.cuda import registry
from vit_cifar_torch.ops.cuda.attention import fused_attention
from vit_cifar_torch.ops.norm import TorchBatchNorm
from vit_cifar_torch.train.checkpoint import save_checkpoint
from vit_cifar_torch.utils.transplant import (flax_from_state_dict,
                                              flax_layout)
from vit_cifar_tpu.config import Config
from vit_cifar_tpu.deploy import _inference_fn, _quantize_store
from vit_cifar_tpu.models import get_model
from vit_cifar_tpu.ops.pallas.attention import \
    flash_attention as jax_flash_attention
from vit_cifar_tpu.ops.pallas.attention import \
    fused_attention as jax_fused_attention
from test_torch_nnmf import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-5)
FUSED_TOL = dict(rtol=1e-4, atol=1e-5)


def _flagship(hidden=32, **kw):
    """A 2-layer ViT in f32: (JAX config, model, variables, port config,
    port model with the same weights)."""
    cfg = Config(model_name="vit", num_layers=2, hidden=hidden,
                 mlp_hidden=hidden, head=4, patch=8, precision="32",
                 synthetic_data=True, **kw)
    model, _ = get_model(cfg)
    tcfg = tconfig.Config.from_json(cfg.to_json())
    tmodel, _ = torch_get_model(tcfg, device="cpu")
    # the port's initial weights as flax's (faster than flax's init)
    return cfg, model, {"params": flax_from_state_dict(tmodel)}, tcfg, tmodel


def _images(seed, B):
    return np.random.default_rng(seed).integers(0, 256, (B, 32, 32, 3),
                                                dtype=np.uint8)


@pytest.fixture(scope="module")
def flagship(tmp_path_factory):
    """The 2-layer ViT, its checkpoint and its f32 artifact on the CPU."""
    tmp = str(tmp_path_factory.mktemp("serving"))
    cfg, model, variables, tcfg, tmodel = _flagship()
    ckpt = os.path.join(tmp, "ckpt")
    save_checkpoint(ckpt, {"params": tmodel.state_dict()}, tcfg)
    art = export_inference(ckpt, os.path.join(tmp, "art"), device="cpu")
    return cfg, model, variables, ckpt, art


@pytest.mark.parametrize("name", ["mhsa_fwd", "mhsa_fwd_lse", "flash_fwd",
                                  "flash_fwd_lse", "flash_bwd_dq",
                                  "flash_bwd_dkv", "seeded_draw"])
def test_operator_passes_opcheck(name):
    """Schema, fake implementation (shapes and strides of the real one) and
    tracing of each registered operator, on CPU tensors."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((2, 3, 9, 16), generator=g) for _ in range(3))
    o, do = (torch.randn((2, 9, 3, 16), generator=g) for _ in range(2))
    lse = torch.randn((2, 3, 9), generator=g)
    args = {"seeded_draw": (q, [2, 5, 3], "normal")}.get(
        name, (q, k, v, o, do, lse, 0.25) if "bwd" in name
        else (q, k, v, 0.25))
    result = torch.library.opcheck(getattr(registry.OPS, name).default, args)
    assert set(result.values()) == {"SUCCESS"}, result


@pytest.mark.parametrize("dist,draw", [("normal", torch.randn),
                                       ("uniform", torch.rand)])
def test_seeded_draw_is_the_eager_seed_0_draw(dist, draw):
    like = torch.zeros(3)
    want = draw((4, 6, 2), generator=torch.Generator().manual_seed(0))
    got = registry.seeded_draw(like, (4, 6, 2), dist)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_artifact_serves_jax_eval_logits_at_any_batch_size(flagship):
    cfg, model, variables, _, art = flagship
    served = load_inference(art, device="cpu")
    infer = jax.jit(_inference_fn(cfg, model, variables["params"], {}))
    imgs = _images(0, 12)
    want = np.asarray(infer(jnp.asarray(imgs)))
    start = 0
    for B in (1, 3, 8):
        got = served.predict(imgs[start:start + B])
        assert got.shape == (B, 10) and got.dtype == np.float32
        np.testing.assert_allclose(got, want[start:start + B], **TOL)
        start += B
    meta = served.meta
    assert meta["device"] == "cpu" and meta["quantize"] is None
    assert meta["quantized"] == 0
    assert meta["bytes"] == os.path.getsize(os.path.join(art, "serving.pt2"))
    assert {"model_name", "num_classes", "input", "output",
            "calling_convention_version", "source_checkpoint",
            "config"} <= set(meta)
    assert "platforms" not in meta


def test_exported_graph_names_the_attention_operator(flagship):
    served = load_inference(flagship[4], device="cpu")
    targets = [str(n.target) for n in served.program.graph.nodes
               if n.op == "call_function"]
    assert targets.count("vit_cifar_torch.mhsa_fwd.default") == 2
    assert not any("flash" in t for t in targets)
    # the batch is symbolic: one input placeholder of shape (b, 32, 32, 3)
    (user_input,) = [n for n in served.program.graph.nodes
                     if n.op == "placeholder"
                     and n.meta["val"].dtype == torch.uint8]
    assert not isinstance(user_input.meta["val"].shape[0], int)


def test_artifact_refuses_another_device(flagship):
    with pytest.raises(ValueError, match="'cpu'.*'cuda'"):
        load_inference(flagship[4], device="cuda")


def test_standalone_process_serves_without_the_package_models(tmp_path,
                                                               flagship):
    """A process that imports torch and ``vit_cifar_torch.ops.cuda`` only
    loads the flagship's artifact and a gated NNMF ham's (whose eval draws
    its bases through the seed-0 operator) from directories without a
    checkpoint, and serves both as this process does."""
    import shutil

    burger = Config(model_name="gnnmf_ham", num_layers=1, hidden=32,
                    mlp_hidden=32, head=1, ffn_features=16, md_iter=2,
                    precision="32")
    model, _ = torch_get_model(tconfig.Config.from_json(burger.to_json()),
                               device="cpu")
    arts = [shutil.copytree(flagship[4], str(tmp_path / "vit")),
            export_model(model, tconfig.Config.from_json(burger.to_json()),
                         str(tmp_path / "gnnmf_ham"), "cpu")]
    imgs = _images(3, 3)
    np.save(tmp_path / "imgs.npy", imgs)
    code = (
        "import sys, numpy as np, torch\n"
        "import vit_cifar_torch.ops.cuda\n"
        "x = torch.from_numpy(np.load(sys.argv[1]))\n"
        "for i, art in enumerate(sys.argv[2:]):\n"
        "    program = torch.export.load(art + '/serving.pt2')\n"
        "    with torch.no_grad():\n"
        "        out = program.module()(x)\n"
        "    np.save(f'{sys.argv[1]}.{i}.npy', out.numpy())\n"
        "bad = sorted(m for m in sys.modules if m.startswith(("
        "'vit_cifar_torch.models', 'vit_cifar_torch.deploy', 'jax', "
        "'vit_cifar_tpu')))\n"
        "assert not bad, bad\n"
        "print('served')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code,
                          str(tmp_path / "imgs.npy"), *arts],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "served"
    for i, art in enumerate(arts):
        assert not os.path.exists(os.path.join(art, "state.pt"))
        got = np.load(f"{tmp_path / 'imgs.npy'}.{i}.npy")
        np.testing.assert_array_equal(
            got, load_inference(art, device="cpu").predict(imgs))


def test_int8_matches_jax_quantize_store_and_int8_eval(tmp_path):
    """hidden 128, as JAX's int8 test: the quantized set, its int8 tensors
    and scales against ``_quantize_store``; the artifact's logits against
    JAX's jitted int8 eval path; the bytes and top-1 against the f32
    artifact."""
    cfg, model, variables, tcfg, tmodel = _flagship(hidden=128)
    store, n_q = _quantize_store(variables["params"])
    ours = quantize_weights(tmodel)
    assert len(ours) == n_q == 14
    owners = dict(tmodel.named_modules())
    for path, entry in store.items():
        name = ".".join(path[:-1] + ("weight",))
        if entry[0] == "raw":
            assert name not in ours or path[-1] != "kernel"
            continue
        q, s = ours[name]
        _, perm = flax_layout(owners[".".join(path[:-1])], "weight")
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        np.testing.assert_array_equal(q.numpy().transpose(perm), entry[1])
        np.testing.assert_allclose(s.numpy().transpose(perm), entry[2],
                                   rtol=1e-7, atol=0)

    imgs = _images(4, 16)
    want = np.asarray(jax.jit(_inference_fn(
        cfg, model, variables["params"], {}, quantize="int8"))(
        jnp.asarray(imgs)))
    f32_art = export_model(tmodel, tcfg, str(tmp_path / "f32"), "cpu")
    f32 = load_inference(f32_art, device="cpu")
    got_f = f32.predict(imgs)
    tmodel, _ = torch_get_model(tcfg, device="cpu")  # the same seed
    int8 = load_inference(export_model(tmodel, tcfg, str(tmp_path / "int8"),
                                       "cpu", quantize="int8"), device="cpu")
    assert int8.meta["quantize"] == "int8" and int8.meta["quantized"] == 14
    got = int8.predict(imgs)
    np.testing.assert_allclose(got, want, **TOL)
    assert int8.meta["bytes"] < 0.6 * f32.meta["bytes"]
    np.testing.assert_array_equal(got.argmax(-1), got_f.argmax(-1))
    # the int8 tensors are tensors of the program, dequantized in its graph
    state = int8.program.state_dict
    assert sum(t.dtype == torch.int8 for t in state.values()) == 14
    assert not any(t.dtype == torch.float32 and t.shape == (128, 128)
                   for t in state.values())


def test_quantize_rejects_unknown_mode(flagship, tmp_path):
    with pytest.raises(ValueError, match="unknown quantize mode"):
        export_inference(flagship[3], str(tmp_path / "art"), quantize="fp4",
                         device="cpu")


@pytest.mark.parametrize("shape", [(1, 1, 1025, 32), (1, 1, 300, 192)],
                         ids=["1x1x1025x32", "1x1x300x192"])
def test_fused_past_the_whole_head_matches_jax(shape):
    """``pallas_kernel="fused"`` where the whole head does not fit in a
    block's shared memory: forward and grads of ``fused_attention`` against
    ``jax.vjp`` of JAX's ``fused_attention`` (interpret mode), and the
    module with ``"fused"`` runs there.

    Past T=1024 JAX's fused VJP is not a reference for dk and dv: its
    ``_bwd`` runs the tiled backward with ``block_q=1024``, whose second
    query tile reads lse rows past the (B, H, round_up(T, 8), 128) residual
    of the fused forward, and its dk and dv come out NaN.  There dk and dv
    are held against ``jax.vjp`` of JAX's ``flash_attention``, the same
    tiled backward fed its own lse; dq and the forward against
    ``fused_attention``."""
    B, H, T, D = shape
    assert route(T, D, "fused") == "fused"
    rng = np.random.default_rng(7)
    q, k, v = (rng.normal(size=shape).astype(np.float32) for _ in range(3))
    g = rng.normal(size=(B, T, H, D)).astype(np.float32)
    scale = 0.1
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    want, vjp = jax.vjp(lambda a, b, c: jax_fused_attention(a, b, c, scale),
                        jq, jk, jv)
    want_grads = [np.asarray(w) for w in vjp(jnp.asarray(g))]
    if T > 1024:
        assert np.isnan(want_grads[1]).all() and np.isnan(want_grads[2]).all()
        _, flash_vjp = jax.vjp(
            lambda a, b, c: jax_flash_attention(a, b, c, scale), jq, jk, jv)
        want_grads[1:] = [np.asarray(w)
                          for w in flash_vjp(jnp.asarray(g))[1:]]
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = fused_attention(*leaves, scale)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               **FUSED_TOL)
    for leaf, w in zip(leaves, want_grads):
        np.testing.assert_allclose(leaf.grad.numpy(), w, **FUSED_TOL)
    m = MultiHeadSelfAttention(H * D, H, pallas_kernel="fused",
                               generator=torch.Generator())
    with torch.no_grad():
        assert m(torch.zeros((1, T, H * D))).shape == (1, T, H * D)


def test_transplant_returns_arrays_that_own_their_memory():
    """``flax_from_state_dict`` copies every leaf: a change of the port's
    buffer or parameter in place afterwards reaches neither the returned
    arrays nor a ``jnp.asarray`` of them (an alias let JAX's asynchronous
    call read a BatchNorm mean that the port had already updated)."""
    bn = TorchBatchNorm(4)
    with torch.no_grad():
        bn.mean.copy_(torch.arange(4.0))
    stats = flax_from_state_dict(bn, collection="batch_stats")
    params = flax_from_state_dict(bn)
    kept = {k: np.array(a) for k, a in {**stats, **params}.items()}
    as_jax = {k: jnp.asarray(a) for k, a in {**stats, **params}.items()}
    with torch.no_grad():
        bn.mean.add_(1.0)
        bn.bias.add_(1.0)
    for name in kept:
        np.testing.assert_array_equal({**stats, **params}[name], kept[name])
        np.testing.assert_array_equal(np.asarray(as_jax[name]), kept[name])
