"""The port's serving path (checkpoint -> export -> ServingModel / HTTP) on
the CPU, against the JAX package's eval forward.

A JAX checkpoint, made as ``tests/test_deploy.py`` makes it, is read through
the JAX package, carried into a port checkpoint with
``state_dict_from_flax``, exported and served.  In f32 (``precision="32"``)
only the order of sums differs between the frameworks: rtol 1e-4, atol 1e-5.
"""

import io
import json
import os
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vit_cifar_torch.config as tconfig
from vit_cifar_torch.deploy import (export_inference, load_inference, main,
                                    make_http_server)
from vit_cifar_torch.train.checkpoint import load_checkpoint, save_checkpoint
from vit_cifar_torch.utils.transplant import state_dict_from_flax
from vit_cifar_tpu.config import Config
from vit_cifar_tpu.data.augment import normalize
from vit_cifar_tpu.models import get_model
from vit_cifar_tpu.train.checkpoint import \
    load_checkpoint as jax_load_checkpoint
from vit_cifar_tpu.train.checkpoint import \
    save_checkpoint as jax_save_checkpoint
from vit_cifar_tpu.train.loop import init_state
from vit_cifar_tpu.train.optim import make_optimizer
from test_torch_nnmf import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """One port checkpoint and its artifact, shared by the tests that only
    read them: (JAX config, model, params, checkpoint path, artifact)."""
    tmp = str(tmp_path_factory.mktemp("deploy"))
    cfg, model, params, ckpt = _port_ckpt(tmp)
    return cfg, model, params, ckpt, export_inference(
        ckpt, os.path.join(tmp, "art"), device="cpu")


def _port_ckpt(tmp_path):
    """A JAX checkpoint carried into a port checkpoint; returns the JAX
    config, model and params, and the port checkpoint's path."""
    cfg = Config(model_name="vit", num_layers=2, hidden=32, mlp_hidden=32,
                 head=4, patch=8, precision="32", synthetic_data=True)
    model, _ = get_model(cfg)
    state = init_state(cfg, model, make_optimizer(cfg, 4),
                       jnp.zeros((2, 32, 32, 3), jnp.float32))
    jax_ckpt = os.path.join(tmp_path, "jax_ckpt")
    jax_save_checkpoint(jax_ckpt, {"params": jax.device_get(state.params)},
                        cfg)
    payload, jcfg = jax_load_checkpoint(jax_ckpt)
    ckpt = os.path.join(tmp_path, "ckpt")
    save_checkpoint(ckpt, {"params": state_dict_from_flax(payload["params"])},
                    tconfig.Config.from_json(jcfg.to_json()))
    return cfg, model, state.params, ckpt


def _want(cfg, model, params, imgs):
    x = normalize(jnp.asarray(imgs), cfg.mean, cfg.std).astype(
        cfg.compute_dtype)
    return np.asarray(model.apply({"params": params}, x, deterministic=True),
                      np.float32)


def _images(seed, B):
    return np.random.default_rng(seed).integers(0, 256, (B, 32, 32, 3),
                                                dtype=np.uint8)


def test_export_serves_jax_eval_logits_at_any_batch_size(exported):
    cfg, model, params, _, out = exported
    served = load_inference(out, device="cpu")
    for B in (3, 8):
        imgs = _images(B, B)
        got = served.predict(imgs)
        assert got.shape == (B, 10) and got.dtype == np.float32
        np.testing.assert_allclose(got, _want(cfg, model, params, imgs), **TOL)

    meta = served.meta
    assert meta["model_name"] == "vit" and meta["device"] == "cpu"
    assert meta["input"] == "uint8[b,32,32,3]"
    assert meta["output"] == "float32[b,10]"
    assert meta["bytes"] == os.path.getsize(os.path.join(out, "serving.pt2"))
    assert meta["config"]["num_layers"] == 2


def test_served_artifact_does_not_need_the_checkpoint(tmp_path, exported):
    import shutil

    ckpt = shutil.copytree(exported[3], os.path.join(tmp_path, "ckpt"))
    out = export_inference(ckpt, os.path.join(tmp_path, "art"), device="cpu")
    shutil.rmtree(ckpt)
    logits = load_inference(out, device="cpu").predict(
        np.zeros((2, 32, 32, 3), np.uint8))
    assert np.isfinite(logits).all()


@pytest.mark.parametrize("shape", [(32, 32, 3), (2, 16, 16, 3),
                                   (2, 32, 32, 1), (0, 32, 32, 3)])
def test_predict_refuses_what_is_not_a_batch_of_images(exported, shape):
    served = load_inference(exported[4], device="cpu")
    with pytest.raises(ValueError, match="expected images"):
        served.predict(np.zeros(shape, np.uint8))


def test_checkpoint_prefers_best_or_last(tmp_path):
    cfg = tconfig.Config(model_name="vit")
    for name, value in (("best", 1.0), ("last", 2.0)):
        save_checkpoint(os.path.join(tmp_path, name),
                        {"params": {"w": torch.tensor([value])}}, cfg)
    os.replace(os.path.join(tmp_path, "best", "config.json"),
               os.path.join(tmp_path, "config.json"))
    best, got_cfg = load_checkpoint(str(tmp_path))
    last, _ = load_checkpoint(str(tmp_path), prefer="last")
    assert got_cfg == cfg
    assert best["params"]["w"].item() == 1.0
    assert last["params"]["w"].item() == 2.0


def test_cli_exports_and_prints_meta(tmp_path, capsys, exported):
    out = os.path.join(tmp_path, "art")
    main([exported[3], out, "--device", "cpu"])
    meta = json.loads(capsys.readouterr().out)
    assert meta["device"] == "cpu" and meta["model_name"] == "vit"
    assert os.path.exists(os.path.join(out, "serving.pt2"))


def test_http_serving_endpoint(exported):
    """Mirrors tests/test_deploy.py::test_http_serving_endpoint: healthz,
    meta, raw .npy and JSON bodies equal to the JAX eval forward, 400 on a
    garbage body, and the server stays up."""
    cfg, model, params, _, out = exported
    srv = make_http_server(out, port=0, device="cpu")
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        assert json.loads(urllib.request.urlopen(
            f"{base}/healthz", timeout=60).read())["ok"]
        meta = json.loads(urllib.request.urlopen(
            f"{base}/meta", timeout=60).read())
        assert meta["model_name"] == "vit" and meta["device"] == "cpu"

        imgs = _images(3, 4)
        want = _want(cfg, model, params, imgs)
        buf = io.BytesIO()
        np.save(buf, imgs)
        req = urllib.request.Request(
            f"{base}/predict", data=buf.getvalue(), method="POST",
            headers={"Content-Type": "application/octet-stream"})
        got = json.loads(urllib.request.urlopen(req, timeout=300).read())
        np.testing.assert_allclose(np.asarray(got["logits"], np.float32),
                                   want, **TOL)
        assert got["pred"] == list(np.argmax(want, -1))

        req = urllib.request.Request(
            f"{base}/predict",
            data=json.dumps({"images": imgs[:2].tolist()}).encode(),
            method="POST", headers={"Content-Type": "application/json"})
        got2 = json.loads(urllib.request.urlopen(req, timeout=300).read())
        np.testing.assert_allclose(np.asarray(got2["logits"], np.float32),
                                   want[:2], **TOL)

        for body, ctype in ((b"garbage", "application/json"),
                            (b"garbage", "application/octet-stream"),
                            (b'{"pixels": []}', "application/json")):
            req = urllib.request.Request(f"{base}/predict", data=body,
                                         method="POST",
                                         headers={"Content-Type": ctype})
            with pytest.raises(urllib.error.HTTPError) as err:
                urllib.request.urlopen(req, timeout=60)
            assert err.value.code == 400
        assert json.loads(urllib.request.urlopen(
            f"{base}/healthz", timeout=60).read())["ok"]
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=60)
        assert not t.is_alive()
