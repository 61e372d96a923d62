"""Serving: checkpoint -> serving artifact -> logits over HTTP.

The port's counterpart of ``vit_cifar_tpu/deploy.py``.  The artifact is a
directory with ``serving.pt`` (the model's weights and buffers,
``torch.save`` of its ``state_dict``) and ``serving.json`` (metadata and
the full config), and the serving process rebuilds the model from the
config with this package.
Inference is exactly the eval path: uint8 (B, H, W, C) -> ``normalize`` ->
cast to the compute dtype -> deterministic forward -> f32 logits.  On a CUDA
device every attention layer runs the hand-written fused-attention kernel.

CLI: ``python -m vit_cifar_torch.deploy <ckpt_dir> <out_dir> [--which
best|last] [--serve PORT] [--device cuda]``.
"""

from __future__ import annotations

import json
import os
import threading
import traceback

import numpy as np
import torch

from .config import Config, torch_dtype
from .data.augment import normalize
from .models import get_model
from .train.checkpoint import load_checkpoint

_ARTIFACT = "serving.pt"
_META = "serving.json"


def export_inference(ckpt_dir: str, out_dir: str, which: str = "best",
                     device: str = "cuda") -> str:
    """Write the serving artifact of a checkpoint; returns ``out_dir``.

    ``device`` is recorded as the device the artifact is meant to serve on.
    """
    payload, cfg = load_checkpoint(ckpt_dir, prefer=which)
    # built on the CPU whatever ``device`` says: it only checks names and
    # shapes and writes the state dict
    model, _ = get_model(cfg, device="cpu")
    # checks names and shapes; the buffers (the persistent bases of
    # --train-md-bases) are the payload's model state, where it has one
    model.load_state_dict({**payload["params"],
                           **payload.get("model_state", {})})
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, _ARTIFACT)
    torch.save(model.state_dict(), path)
    meta = {
        "model_name": cfg.model_name,
        "num_classes": cfg.num_classes,
        "input": f"uint8[b,{cfg.img_size},{cfg.img_size},{cfg.in_c}]",
        "output": f"float32[b,{cfg.num_classes}]",
        "device": device,
        "bytes": os.path.getsize(path),
        "quantize": None,
        "source_checkpoint": os.path.abspath(ckpt_dir),
        "config": json.loads(cfg.to_json()),
    }
    with open(os.path.join(out_dir, _META), "w") as f:
        json.dump(meta, f, indent=2)
    return out_dir


class ServingModel:
    """An artifact loaded on ``device``; ``predict`` serves any batch size."""

    def __init__(self, out_dir: str, device):
        with open(os.path.join(out_dir, _META)) as f:
            meta = json.load(f)
        self.cfg = Config.from_json(json.dumps(meta["config"]))
        self.device = torch.device(device)
        self.meta = {**meta, "device": str(self.device)}
        self.model, _ = get_model(self.cfg, device=self.device)
        self.model.load_state_dict(torch.load(
            os.path.join(out_dir, _ARTIFACT), map_location=self.device,
            weights_only=True))
        self.model.eval().requires_grad_(False)
        self._lock = threading.Lock()  # one model, one device: one call at a time

    def infer(self, img_u8: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) uint8 on the model's device -> (B, num_classes) f32
        logits, by the eval path."""
        x = normalize(img_u8, self.cfg.mean, self.cfg.std)
        return self.model(x.to(torch_dtype(self.cfg)),
                          deterministic=True).to(torch.float32)

    def predict(self, imgs_u8) -> np.ndarray:
        """(B, H, W, C) uint8 array -> (B, num_classes) float32 logits."""
        imgs = np.asarray(imgs_u8)
        want = (self.cfg.img_size, self.cfg.img_size, self.cfg.in_c)
        if imgs.ndim != 4 or imgs.shape[1:] != want or imgs.shape[0] < 1:
            raise ValueError(f"expected images of shape (B, {want[0]}, "
                             f"{want[1]}, {want[2]}), got {imgs.shape}")
        x = torch.from_numpy(np.ascontiguousarray(imgs, dtype=np.uint8))
        with self._lock, torch.inference_mode():
            return self.infer(x.to(self.device)).cpu().numpy()


def load_inference(out_dir: str, device) -> ServingModel:
    return ServingModel(out_dir, device)


def make_http_server(artifact_dir: str, port: int = 0, *, device):
    """A stdlib HTTP endpoint over a loaded artifact.

    POST /predict with a raw .npy body (uint8, (B,H,W,C)) or JSON
    ``{"images": [[...]]}`` -> JSON ``{"logits": [[...]], "pred": [...]}``;
    a body that is not a batch of images gets 400.  GET /meta returns the
    artifact metadata, GET /healthz liveness.
    """
    import io
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    model = load_inference(artifact_dir, device)

    class Handler(BaseHTTPRequestHandler):
        server_version = "vit_cifar_torch_serving/1"

        def log_message(self, fmt, *args):
            pass

        def _send(self, obj, status=200):
            data = json.dumps(obj).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            if self.path == "/healthz":
                self._send({"ok": True})
            elif self.path == "/meta":
                self._send(model.meta)
            else:
                self._send({"error": "not found"}, 404)

        def do_POST(self):
            if self.path != "/predict":
                return self._send({"error": "not found"}, 404)
            n = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(n)
            try:
                if self.headers.get("Content-Type", "").startswith(
                        "application/json"):
                    imgs = np.asarray(json.loads(body)["images"], np.uint8)
                else:  # raw .npy
                    imgs = np.load(io.BytesIO(body), allow_pickle=False)
                logits = model.predict(imgs)
            except (ValueError, KeyError, TypeError, EOFError) as e:
                return self._send({"error": repr(e)}, 400)
            except Exception as e:  # keep serving; report the fault
                traceback.print_exc()
                return self._send({"error": repr(e)}, 500)
            self._send({"logits": logits.tolist(),
                        "pred": logits.argmax(-1).tolist()})

    return ThreadingHTTPServer(("127.0.0.1", port), Handler)


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("ckpt_dir")
    p.add_argument("out_dir")
    p.add_argument("--which", default="best", choices=["best", "last"])
    p.add_argument("--serve", type=int, default=0, metavar="PORT",
                   help="after exporting, serve the artifact over HTTP "
                        "(POST /predict) on this port")
    p.add_argument("--device", default="cuda",
                   help="the torch device to serve on (default cuda)")
    a = p.parse_args(argv)
    out = export_inference(a.ckpt_dir, a.out_dir, which=a.which,
                           device=a.device)
    with open(os.path.join(out, _META)) as f:
        print(f.read())
    if a.serve:
        srv = make_http_server(out, a.serve, device=a.device)
        print(f"serving on http://127.0.0.1:{srv.server_address[1]}/predict")
        srv.serve_forever()


if __name__ == "__main__":
    main()
