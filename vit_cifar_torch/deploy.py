"""Serving: checkpoint -> a self-contained exported artifact -> logits over
HTTP.

The port's counterpart of ``vit_cifar_tpu/deploy.py``.  Where the JAX
package lowers the jitted eval path with ``jax.export``, the port exports
it with ``torch.export``: ``serving.pt2`` is one ``ExportedProgram`` of
uint8 (B, H, W, C) -> ``normalize`` -> the compute dtype -> the
deterministic forward -> f32 logits, with the weights and buffers inside.
A serving process loads it with ``torch.export.load`` after importing
``vit_cifar_torch.ops.cuda``, which registers the port's operators (the
attention kernels and the seed-0 draw of the eval path): it needs neither
the model code nor the checkpoint.

  * the batch dimension is symbolic (``torch.export.Dim``), exported from
    an example batch of 2, so one artifact serves any batch size;
  * the artifact is exported on the device it serves on (``--device``,
    default ``cuda``) and records it; loading it for another device raises.
    On the card every attention layer runs its kernel as an operator of the
    graph (``vit_cifar_torch::mhsa_fwd``, or ``flash_fwd`` at long
    sequences); on the CPU the same operators run their plain versions.
    JAX's ``--platforms`` has no counterpart;
  * ``--quantize int8``: weight-only post-training quantization, as JAX's
    ``_quantize_store``/``_dequantize``.  Exactly the tensors whose flax
    counterpart is a 2-D-or-more f32 ``kernel`` (the Linear and convolution
    weights, as ``utils/transplant.py`` maps them) are stored as int8 with a
    symmetric per-output-channel f32 scale (absmax/127, 1 for a zero
    channel); norms, biases, cls, pos, NNMF weights, the experts' stacked
    weights and every buffer stay exact.  The int8 tensors and scales are
    tensors of the exported program and the dequantize (``q.float() * s``)
    is part of its graph, run at call time, so the file shrinks.

``serving.json`` keeps the JAX package's keys, with ``device`` in place of
``platforms``; ``calling_convention_version`` is the torch version that
wrote the artifact, ``quantized`` the number of int8 tensors.

CLI: ``python -m vit_cifar_torch.deploy <ckpt_dir> <out_dir> [--which
best|last] [--quantize int8] [--serve PORT] [--device cuda]``.
"""

from __future__ import annotations

import json
import os
import threading
import traceback

import numpy as np
import torch
from torch import nn

from .data.augment import normalize

_ARTIFACT = "serving.pt2"
_META = "serving.json"


def quantize_weights(model: nn.Module) -> dict[str, tuple]:
    """``{name: (int8 q, f32 scale)}`` for every parameter of ``model``
    whose flax counterpart is a 2-D-or-more f32 ``kernel``
    (``transplant.flax_layout``): symmetric per-output-channel absmax/127,
    reduced over every axis but the one that flax puts last, with a zero
    channel's scale set to 1, as JAX's ``_quantize_store``."""
    from .utils.transplant import flax_layout

    owners = dict(model.named_modules())
    out = {}
    for name, p in model.named_parameters():
        *mod, leaf = name.split(".")
        flax_leaf, perm = flax_layout(owners[".".join(mod)], leaf)
        if flax_leaf != "kernel" or p.dim() < 2 or p.dtype != torch.float32:
            continue
        w = p.detach()
        red = [a for a in range(w.dim()) if a != perm[-1]]
        s = w.abs().amax(dim=red, keepdim=True) / 127.0
        s = torch.where(s == 0, 1.0, s)
        out[name] = (torch.round(w / s).to(torch.int8), s)
    return out


class _Dequantize(nn.Module):
    """The parametrization that rebuilds an f32 weight from its int8
    tensor inside the graph: ``q.float() * scale``."""

    def __init__(self, scale: torch.Tensor):
        super().__init__()
        self.register_buffer("scale", scale)

    def forward(self, q: torch.Tensor) -> torch.Tensor:
        return q.to(torch.float32) * self.scale


def _store_int8(model: nn.Module, store: dict[str, tuple]) -> None:
    """Replace each quantized parameter of ``model`` by its int8 tensor (a
    buffer) and a ``_Dequantize`` parametrization."""
    from torch.nn.utils import parametrize

    owners = dict(model.named_modules())
    for name, (q, s) in store.items():
        *mod, leaf = name.split(".")
        owner = owners[".".join(mod)]
        delattr(owner, leaf)
        owner.register_buffer(leaf, q)
        parametrize.register_parametrization(owner, leaf, _Dequantize(s),
                                             unsafe=True)


class _EvalPath(nn.Module):
    """The exported function: uint8 images -> f32 logits by the eval path
    (``train/steps.py``'s eval step)."""

    def __init__(self, model: nn.Module, mean, std, dtype: torch.dtype):
        super().__init__()
        self.model, self.mean, self.std, self.dtype = model, mean, std, dtype

    def forward(self, img_u8: torch.Tensor) -> torch.Tensor:
        x = normalize(img_u8, self.mean, self.std).to(self.dtype)
        return self.model(x, deterministic=True).to(torch.float32)


def export_model(model: nn.Module, cfg, out_dir: str, device,
                 quantize: str | None = None,
                 source_checkpoint: str | None = None) -> str:
    """Export ``model`` (built from ``cfg``, its weights loaded) by the eval
    path into ``out_dir`` on ``device``; returns ``out_dir``.  The model is
    moved to ``device`` and, under ``quantize="int8"``, changed in place."""
    from .config import torch_dtype

    if quantize not in (None, "int8"):
        raise ValueError(f"unknown quantize mode {quantize!r} (only 'int8')")
    device = torch.device(device)
    model.to(device).requires_grad_(False)
    n_q = 0
    if quantize == "int8":
        store = quantize_weights(model)
        _store_int8(model, store)
        n_q = len(store)
    sample = torch.zeros((2, cfg.img_size, cfg.img_size, cfg.in_c),
                         dtype=torch.uint8, device=device)
    program = torch.export.export(
        _EvalPath(model, cfg.mean, cfg.std, torch_dtype(cfg)), (sample,),
        dynamic_shapes={"img_u8": {0: torch.export.Dim("b", min=1)}})
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, _ARTIFACT)
    torch.export.save(program, path)
    meta = {
        "model_name": cfg.model_name,
        "num_classes": cfg.num_classes,
        "input": f"uint8[b,{cfg.img_size},{cfg.img_size},{cfg.in_c}]",
        "output": f"float32[b,{cfg.num_classes}]",
        "device": device.type,
        "calling_convention_version": torch.__version__,
        "bytes": os.path.getsize(path),
        "quantize": quantize,
        "quantized": n_q,
        "source_checkpoint": source_checkpoint,
        "config": json.loads(cfg.to_json()),
    }
    with open(os.path.join(out_dir, _META), "w") as f:
        json.dump(meta, f, indent=2)
    return out_dir


def export_inference(ckpt_dir: str, out_dir: str, which: str = "best",
                     quantize: str | None = None,
                     device: str = "cuda") -> str:
    """Export a trained checkpoint as a serving artifact for ``device``;
    returns ``out_dir``."""
    from .models import get_model
    from .train.checkpoint import load_checkpoint

    payload, cfg = load_checkpoint(ckpt_dir, prefer=which)
    model, _ = get_model(cfg, device=device)
    # checks names and shapes; the buffers (BatchNorm's statistics, the
    # persistent bases of --train-md-bases) are the payload's model state
    model.load_state_dict({**payload["params"],
                           **payload.get("model_state", {})})
    return export_model(model, cfg, out_dir, device, quantize,
                        source_checkpoint=os.path.abspath(ckpt_dir))


class ServingModel:
    """An exported artifact loaded for ``device``; ``predict`` serves any
    batch size.  It rebuilds no model and reads no checkpoint."""

    def __init__(self, out_dir: str, device):
        with open(os.path.join(out_dir, _META)) as f:
            self.meta = json.load(f)
        self.device = torch.device(device)
        if self.device.type != self.meta["device"]:
            raise ValueError(
                f"the artifact in {out_dir} was exported for device "
                f"{self.meta['device']!r}; it cannot serve on "
                f"{self.device.type!r}: export it again with --device "
                f"{self.device.type}")
        from .ops import cuda  # noqa: F401  (registers the operators)

        self.program = torch.export.load(os.path.join(out_dir, _ARTIFACT))
        self._forward = self.program.module()
        # "uint8[b,H,W,C]"
        self.image_shape = tuple(
            int(n) for n in self.meta["input"].split("[b,")[1][:-1].split(","))
        self._lock = threading.Lock()  # one program, one device: one call at a time

    def infer(self, img_u8: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) uint8 on the artifact's device -> (B, num_classes)
        f32 logits."""
        return self._forward(img_u8)

    def predict(self, imgs_u8) -> np.ndarray:
        """(B, H, W, C) uint8 array -> (B, num_classes) float32 logits."""
        imgs = np.asarray(imgs_u8)
        want = self.image_shape
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
    p.add_argument("--quantize", default=None, choices=["int8"],
                   help="weight-only post-training quantization of the "
                        "exported kernels (per-channel symmetric int8)")
    p.add_argument("--serve", type=int, default=0, metavar="PORT",
                   help="after exporting, serve the artifact over HTTP "
                        "(POST /predict) on this port")
    p.add_argument("--device", default="cuda",
                   help="the torch device to export for and serve on "
                        "(default cuda)")
    a = p.parse_args(argv)
    out = export_inference(a.ckpt_dir, a.out_dir, which=a.which,
                           quantize=a.quantize, device=a.device)
    with open(os.path.join(out, _META)) as f:
        print(f.read())
    if a.serve:
        srv = make_http_server(out, a.serve, device=a.device)
        print(f"serving on http://127.0.0.1:{srv.server_address[1]}/predict")
        srv.serve_forever()


if __name__ == "__main__":
    main()
