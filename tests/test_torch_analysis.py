"""The port's analysis tools (``vit_cifar_torch/analysis/``) and the
training loop's graph artifacts, on the CPU, against the JAX package on the
same transplanted weights and images.

* ``collect_attention_maps`` of the modules' ``attn_map`` attributes
  against JAX's maps from ``intermediates`` (f32, 1e-5: the same softmax,
  sums in another order); ``get_joint_attentions`` against the reference
  formula (1e-6) and JAX's; ``rollout_test_vector`` equal to JAX's;
  ``model_payload`` against JAX's (the uint8 maps equal or one step apart,
  since a map a rounding step away may round to the next level).
* ``module_rows`` of a 2-layer ViT: the paths, output shapes and parameter
  counts of JAX's tabulate at depth 5, wherever both have the module.
* The dashboard, the live server, the curves, the graph PNGs and the
  regenerator write the files that JAX's tests assert; ``train()`` writes
  ``model_graph.txt``, ``model_graph.png``, the encoder-block PNG and
  ``input_grid.png``.
"""

import base64
import io
import json
import os
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vit_cifar_torch.config as tconfig
from vit_cifar_torch.analysis import interactive as tinteractive
from vit_cifar_torch.analysis.attention_maps import (collect_attention_maps,
                                                     get_joint_attentions)
from vit_cifar_torch.analysis.graph_render import (encoder_block_rows,
                                                   graph_table, module_rows,
                                                   render_graph)
from vit_cifar_torch.analysis.run_model import (find_checkpoints,
                                                intermediates,
                                                load_run_model)
from vit_cifar_torch.models import get_model as torch_get_model
from vit_cifar_torch.train import checkpoint as tcheckpoint
from vit_cifar_torch.utils.transplant import (flax_from_state_dict,
                                              state_dict_from_flax)
from vit_cifar_tpu.analysis import attention_maps as jmaps
from vit_cifar_tpu.analysis import interactive as jinteractive
from vit_cifar_tpu.analysis.graph_render import module_rows as jax_rows
from vit_cifar_tpu.config import Config
from vit_cifar_tpu.models import get_model
from vit_cifar_tpu.train import checkpoint as jcheckpoint
from test_torch_nnmf import one_torch_thread  # noqa: F401 (autouse)

SMALL = dict(model_name="vit", num_layers=2, hidden=48, mlp_hidden=48,
             head=4, batch_size=16, eval_batch_size=8, precision="32",
             synthetic_data=True, warmup_epoch=0)


def _init(cfg):
    """The JAX model of ``cfg`` and the port's initial weights as its
    variables (faster than flax's init, which runs op by op)."""
    model, _ = get_model(cfg)
    tmodel, _ = torch_get_model(tconfig.Config.from_json(cfg.to_json()),
                                device="cpu")
    return model, {"params": flax_from_state_dict(tmodel)}


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """One set of ViT weights as a JAX checkpoint and a port checkpoint
    (``models/<experiment>`` layout, as training writes them)."""
    root = tmp_path_factory.mktemp("analysis")
    cfg = Config(**SMALL)
    _, variables = _init(cfg)
    jax_ckpt, port_ckpt = str(root / "jax" / "exp"), str(root / "port" / "exp")
    jcheckpoint.save_checkpoint(jax_ckpt, {"params": variables["params"],
                                           "model_state": {}}, cfg)
    tcheckpoint.save_checkpoint(
        port_ckpt, {"params": state_dict_from_flax(variables["params"])},
        tconfig.Config.from_json(cfg.to_json()))
    return jax_ckpt, port_ckpt


def test_attention_maps_match_jax_intermediates():
    cfg = Config(**SMALL).replace(save_attn_map=True)
    model, variables = _init(cfg)
    x = np.random.default_rng(0).normal(size=(3, 32, 32, 3)).astype(
        np.float32)
    _, inter = jax.jit(lambda v, a: model.apply(
        v, a, deterministic=True, mutable=["intermediates"]))(
        variables, jnp.asarray(x))
    want = jmaps.collect_attention_maps(inter["intermediates"])
    tmodel, _ = torch_get_model(tconfig.Config.from_json(cfg.to_json()),
                                device="cpu")
    tmodel.load_state_dict(state_dict_from_flax(variables["params"]))
    with torch.no_grad():
        tmodel(torch.from_numpy(x), deterministic=True)
    got = collect_attention_maps(intermediates(tmodel))
    assert got.shape == want.shape == (2, 3, 4, 65, 65)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.sum(-1), 1.0, rtol=1e-5)
    joint = get_joint_attentions(got)
    np.testing.assert_allclose(joint, jmaps.get_joint_attentions(want),
                               rtol=1e-5, atol=1e-5)
    assert get_joint_attentions(got, token=0).shape == (2, 3, 4, 65)
    with pytest.raises(ValueError, match="No attention maps"):
        collect_attention_maps({})


def test_rollout_matches_the_reference_formula():
    """JAX's ``test_rollout_math_matches_reference_formula`` vector."""
    rng = np.random.default_rng(0)
    raw = rng.uniform(0, 1, (3, 1, 2, 5, 5)).astype(np.float32)
    raw = raw / raw.sum(-1, keepdims=True)
    joint = get_joint_attentions(raw)
    aug = raw + np.eye(5, dtype=np.float32)
    aug = aug / aug.sum(-1, keepdims=True)
    np.testing.assert_allclose(joint[0], aug[0], rtol=1e-6)
    np.testing.assert_allclose(joint[1], np.matmul(aug[1], aug[0]),
                               rtol=1e-6)
    np.testing.assert_allclose(joint, jmaps.get_joint_attentions(raw),
                               rtol=1e-6, atol=1e-6)
    assert tinteractive.rollout_test_vector() == \
        jinteractive.rollout_test_vector()


def test_model_payload_matches_jax(ckpts):
    jax_ckpt, port_ckpt = ckpts
    want = jinteractive.model_payload(jax_ckpt, batch_size=4)
    got = tinteractive.model_payload(port_ckpt, batch_size=4, device="cpu")
    assert set(got) == set(want)
    for key in ("name", "shape", "imgs_b64", "img_hw", "preds", "patch",
                "is_cls"):
        assert got[key] == want[key], key
    np.testing.assert_allclose(got["scales"], want["scales"], rtol=1e-5,
                               atol=2e-6)
    q_got, q_want = (np.frombuffer(base64.b64decode(p["attn_b64"]), np.uint8)
                     .astype(np.int16) for p in (got, want))
    assert np.abs(q_got - q_want).max() <= 1


def test_load_run_model_and_find_checkpoints(ckpts):
    root = os.path.dirname(ckpts[1])
    assert find_checkpoints(root) == [ckpts[1]]
    assert find_checkpoints(os.path.join(root, "missing")) == []
    model, cfg, imgs, logits, inter = load_run_model(ckpts[1], batch_size=4,
                                                     device="cpu")
    assert cfg.save_attn_map and imgs.shape == (4, 32, 32, 3)
    assert logits.shape == (4, 10) and np.isfinite(logits).all()
    assert collect_attention_maps(inter).shape[:2] == (2, 4)


def test_module_rows_match_jax_tabulate():
    cfg = Config(**SMALL)
    model, _ = get_model(cfg)
    k = jax.random.PRNGKey(0)
    want = jax_rows(model, {"params": k, "dropout": k, "mask": k},
                    jnp.zeros((2, 32, 32, 3)), depth=5, deterministic=True)
    tmodel, _ = torch_get_model(tconfig.Config.from_json(cfg.to_json()),
                                device="cpu")
    got = module_rows(tmodel, torch.zeros((2, 32, 32, 3)), depth=5,
                      deterministic=True)
    by_path = {r.path: r for r in got}
    both = [r for r in want if r.path in by_path]
    assert len(both) >= 26
    assert [r.path for r in got] == [r.path for r in both]  # call order
    for r in both:
        ours = by_path[r.path]
        assert (ours.out_shape, ours.n_params) == (r.out_shape, r.n_params), \
            r.path
    assert got[0].path == () and got[0].out_shape == (2, 10)
    enc = encoder_block_rows(got)
    assert {"la1", "mixer", "la2", "mlp"} <= {r.path[-1] for r in enc}
    table = graph_table(got)
    assert "enc0/mixer/Wq" in table and "TOTAL" in table


def test_graph_pngs_and_the_model_without_an_encoder(tmp_path):
    cfg = tconfig.Config(**SMALL)
    model, _ = torch_get_model(cfg, device="cpu")
    rows = module_rows(model, torch.zeros((2, 32, 32, 3)), depth=5,
                       deterministic=True)
    p1, p2 = tmp_path / "model.png", tmp_path / "enc.png"
    render_graph([r for r in rows if len(r.path) <= 2], str(p1))
    render_graph(encoder_block_rows(rows), str(p2))
    assert p1.stat().st_size > 5000 and p2.stat().st_size > 5000
    cnn, _ = torch_get_model(tconfig.Config(model_name="cnn_baseline",
                                            precision="32"), device="cpu")
    rows = module_rows(cnn, torch.zeros((2, 32, 32, 3)), depth=4,
                       deterministic=True)
    assert rows and encoder_block_rows(rows) is None


def test_dashboard_report_and_interactive_viewer(ckpts, tmp_path):
    from vit_cifar_torch.analysis.dashboard import generate_report
    from vit_cifar_torch.analysis.interactive import generate_interactive

    index = generate_report(ckpts[1], out_dir=str(tmp_path / "report"),
                            image_index=0, token=1, batch_size=4,
                            device="cpu")
    assert os.path.exists(index)
    pngs = sorted(f for f in os.listdir(tmp_path / "report")
                  if f.endswith(".png"))
    assert pngs == sorted(["input_grid.png"] + [
        f"{kind}_l{i}.png" for i in range(2)
        for kind in ("attn", "rollout", "overlay")])
    index = generate_interactive([ckpts[1]], out_dir=str(tmp_path / "rep"),
                                 batch_size=4, device="cpu")
    html = open(index).read()
    for needle in ('<script src="data_0.js">', 'id="model"', 'id="token"',
                   'id="heads"', 'id="transpose"', 'id="cmap"',
                   "function rolloutSelfTest()", "rolloutSelfTest();"):
        assert needle in html
    js = open(tmp_path / "rep" / "data_0.js").read()
    payload = json.loads(js[js.index("push(") + 5:-2])
    assert payload["shape"] == [2, 4, 4, 65, 65]


def test_live_server_recomputes_reports(ckpts):
    from PIL import Image

    from vit_cifar_torch.analysis.server import make_server

    srv = make_server(ckpt_dir=os.path.dirname(ckpts[1]), port=0,
                      batch_size=2, device="cpu")
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        page = urllib.request.urlopen(f"{base}/", timeout=120).read().decode()
        assert "exp" in page and "recompute" in page
        assert b'"ok": true' in urllib.request.urlopen(
            f"{base}/healthz", timeout=30).read()
        rep = urllib.request.urlopen(
            f"{base}/report?ckpt=0&image=1&token=3", timeout=600
        ).read().decode()
        assert rep.count("data:image/png;base64,") >= 6
        assert "token 3" in rep and "predicted class" in rep

        buf = io.BytesIO()
        Image.fromarray(np.random.default_rng(0).integers(
            0, 256, (48, 48, 3), np.uint8)).save(buf, format="PNG")
        boundary = "XBOUNDX"
        body = (
            f"--{boundary}\r\n"
            'Content-Disposition: form-data; name="ckpt"\r\n\r\n0\r\n'
            f"--{boundary}\r\n"
            'Content-Disposition: form-data; name="token"\r\n\r\n0\r\n'
            f"--{boundary}\r\n"
            'Content-Disposition: form-data; name="file"; '
            'filename="x.png"\r\nContent-Type: image/png\r\n\r\n'
        ).encode() + buf.getvalue() + f"\r\n--{boundary}--\r\n".encode()
        req = urllib.request.Request(
            f"{base}/upload", data=body, method="POST",
            headers={"Content-Type":
                     f"multipart/form-data; boundary={boundary}"})
        up = urllib.request.urlopen(req, timeout=600).read().decode()
        assert up.count("data:image/png;base64,") >= 6
        assert "predicted class" in up
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=60)


def test_curves_from_the_port_logger(tmp_path):
    from vit_cifar_torch.analysis.curves import plot_curves, read_metrics
    from vit_cifar_torch.utils.logging import CSVLogger

    logger = CSVLogger(str(tmp_path), "exp")
    for e in range(3):
        logger.log(e * 10, e, loss=1.0 / (e + 1), acc=0.3 * e,
                   val_loss=1.2 / (e + 1), val_acc=0.25 * e)
    logger.flush()
    assert len(read_metrics(logger.dir)["loss"]) == 3
    out = plot_curves([logger.dir], out_dir=str(tmp_path / "imgs"))
    assert all(os.path.exists(p) for p in out)
    assert {os.path.basename(p) for p in out} == {"acc.png", "loss.png"}


def test_regenerator_study_and_score_matrices(tmp_path, monkeypatch):
    from vit_cifar_torch.analysis import regenerator as regen
    from vit_cifar_torch.data import datasets

    net = regen.RegeneratorNet(hidden=24, patch=4, ae_hidden=8,
                               generator=torch.Generator(), device="cpu")
    regen_in, masked_out = net(torch.zeros((2, 32, 32, 3)), mask=True)
    assert regen_in.shape == (2, 17, 24)
    assert masked_out.shape == (2, 17, 17, 24)
    cos, mse = regen.score_matrices(regen_in, masked_out)
    assert cos.shape == mse.shape == (2, 17, 17)

    real_load = datasets.load_dataset

    def small_load(dataset, data_dir="data", synthetic=False):
        raw = real_load(dataset, data_dir, synthetic=True)
        return datasets.RawData(raw.x_train[:64], raw.y_train[:64],
                                raw.x_test[:16], raw.y_test[:16],
                                raw.num_classes, synthetic=True)

    monkeypatch.setattr(regen, "load_dataset", small_load)
    hist = regen.run_study(epochs=1, batch_size=32, hidden=48, patch=8,
                           log_interval=2, out_dir=str(tmp_path),
                           synthetic=True, verbose=False, device="cpu")
    assert len(hist) == 1
    assert np.isfinite(hist[0]["loss"]) and np.isfinite(hist[0]["score"])
    for name in ("reconstruction.png", "metrics.csv", "scores_1.png"):
        assert os.path.exists(tmp_path / name), name


def test_train_writes_the_graph_artifacts_and_input_grid(tmp_path,
                                                         monkeypatch):
    """One epoch (not a dry run, which skips the grid) over a data set cut
    to 64 training and 16 test images."""
    from vit_cifar_torch.data import datasets
    from vit_cifar_torch.train import loop

    real_load = datasets.load_dataset

    def small_load(dataset, data_dir="data", synthetic=False):
        raw = real_load(dataset, data_dir, synthetic=True)
        return datasets.RawData(raw.x_train[:64], raw.y_train[:64],
                                raw.x_test[:16], raw.y_test[:16],
                                raw.num_classes, synthetic=True)

    monkeypatch.setattr(loop, "load_dataset", small_load)
    cfg = tconfig.Config(**SMALL).replace(
        max_epochs=1, log_dir=str(tmp_path / "logs"),
        ckpt_dir=str(tmp_path / "models"))
    res = loop.train(cfg, verbose=False, device="cpu")
    names = os.listdir(res["log_dir"])
    for name in ("model_graph.txt", "model_graph.png", "input_grid.png"):
        assert name in names, name
    assert f"{res['experiment']}_encoder_block.png" in names
    table = open(os.path.join(res["log_dir"], "model_graph.txt")).read()
    assert "enc1/mixer" in table
