"""Smoke run of the PyTorch port (``vit_cifar_torch``) on one CUDA card.

Run from the root of a checkout: ``python3 chip_smoke.py``.

1. Kernel phase: builds the fused-attention kernel from
   ``vit_cifar_torch/csrc/`` with nvcc and holds it against its plain PyTorch
   version on the card, at the model's shape and the JAX tests' ragged
   shapes, in f32 and bf16; times both at the model's shape.
2. Slice phase: the serving path at the full width of the README recipe
   model (7 layers, hidden 384, 12 heads; random weights from the config's
   seed): ``get_model`` -> ``save_checkpoint`` -> ``export_inference`` ->
   ``make_http_server``, then POST /predict requests (raw .npy at B=1, 8 and
   128, and one JSON body), each checked against the in-process forward with
   the attention forced to the plain version, and the kernel's launch
   counter checked to rise by one per attention layer and request.

Prints the card's name and power limit, every check and time, then a JSON
line of the kernels and, last, ``{"ok": true, "device": {...}}``.  Any
failure exits non-zero before that line; with no CUDA card it exits
non-zero at once.  Work files go to ``build/chip_smoke/`` in the checkout.
"""

from __future__ import annotations

import io
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import torch

from vit_cifar_torch import Config, torch_dtype
from vit_cifar_torch.data.augment import normalize
from vit_cifar_torch.deploy import (ServingModel, export_inference,
                                    make_http_server)
from vit_cifar_torch.models import get_model
from vit_cifar_torch.ops.cuda.attention import (fused_attention,
                                                fused_attention_reference)
from vit_cifar_torch.ops.cuda.build import library_path, load_library
from vit_cifar_torch.train.checkpoint import save_checkpoint

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")
# the model's attention shape first, then the JAX kernel tests' ragged shapes
SHAPES = [(128, 12, 65, 32), (2, 4, 9, 16), (2, 3, 65, 32), (1, 2, 130, 64),
          (2, 2, 96, 128)]
# kernel vs plain version: the same f32 math with sums in another order; in
# bf16 the output may round one bf16 step (2**-7 relative) the other way
KERNEL_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
              torch.bfloat16: dict(rtol=1e-2, atol=1e-2)}
# served logits (kernel path) vs the plain path in bf16-mixed: the plain
# path rounds logits and probabilities to bf16, the kernel keeps them in
# f32; through 7 layers that is a few bf16 steps at logits of order 1
LOGIT_TOL = dict(rtol=5e-2, atol=5e-2)
REQUESTS = [("npy", 1), ("npy", 8), ("npy", 128), ("json", 4)]
PARAMS = 6_268_810


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 100, warmup: int = 10) -> float:
    """Mean ms of ``fn`` on the card over a CUDA-event window."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn, iters: int, warmup: int = 3) -> float:
    """Median host-clock ms of ``fn``, which ends in a host read."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def kernel_phase(card: str) -> dict:
    t0 = time.perf_counter()
    load_library("mhsa_fwd")
    print(f"built {os.path.relpath(library_path('mhsa_fwd'), ROOT)} in "
          f"{time.perf_counter() - t0:.1f} s")
    log = library_path("mhsa_fwd").with_suffix(".log")
    for line in log.read_text().splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())

    gen = torch.Generator(device="cuda").manual_seed(0)
    main_err = None
    for shape in SHAPES:
        B, H, T, D = shape
        scale = 1.0 / math.sqrt(H * D)  # the model's 1/sqrt(features)
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.randn(shape, generator=gen, device="cuda")
                       .to(dtype) for _ in range(3))
            got = fused_attention(q, k, v, scale)
            want = fused_attention_reference(q, k, v, scale)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            tol = KERNEL_TOL[dtype]
            torch.testing.assert_close(got, want, **tol)
            print(f"kernel check {shape} {str(dtype)[6:]}: max_abs_err "
                  f"{err:.3e} within rtol={tol['rtol']} atol={tol['atol']}")
            if shape == SHAPES[0] and dtype == torch.bfloat16:
                main_err = err

    # the model's shape in bf16, in turns: plain, kernel, kernel, plain
    B, H, T, D = SHAPES[0]
    q, k, v = (torch.randn(SHAPES[0], generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    scale = 1.0 / math.sqrt(H * D)
    times = {"kernel": [], "plain": []}
    fns = {"kernel": lambda: fused_attention(q, k, v, scale),
           "plain": lambda: fused_attention_reference(q, k, v, scale)}
    for _ in range(3):
        for name in ("plain", "kernel", "kernel", "plain"):
            times[name].append(cuda_ms(fns[name]))
    ms = {name: statistics.median(t) for name, t in times.items()}
    for name in ("kernel", "plain"):
        print(f"fused attention fwd {SHAPES[0]} bf16, {name}: "
              f"{ms[name]:.4f} ms (median of {len(times[name])} windows of "
              f"100; {card})")
    return {"name": "mhsa_fwd", "route": "cuda",
            "source": "vit_cifar_torch/csrc/mhsa_fwd.cu",
            "replaces": "vit_cifar_tpu/ops/pallas/attention.py:90",
            "max_abs_err": main_err, "ms": ms["kernel"],
            "plain_ms": ms["plain"]}


def _post(url: str, kind: str, imgs: np.ndarray) -> dict:
    if kind == "npy":
        buf = io.BytesIO()
        np.save(buf, imgs)
        data, ctype = buf.getvalue(), "application/octet-stream"
    else:
        data, ctype = json.dumps({"images": imgs.tolist()}).encode(), \
            "application/json"
    req = urllib.request.Request(url, data=data, method="POST",
                                 headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=300) as resp:
        return json.loads(resp.read())


def _get(url: str) -> dict:
    with urllib.request.urlopen(url, timeout=60) as resp:
        return json.loads(resp.read())


def slice_phase(card: str) -> int:
    # the main path starts here: every launch counted from now until the last
    # request is the served model's
    fused_attention.launches = 0
    cfg = Config(model_name="vit", num_layers=7, hidden=384, mlp_hidden=384,
                 head=12)
    model, _ = get_model(cfg, generator=torch.Generator().manual_seed(cfg.seed))
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != PARAMS:
        raise AssertionError(f"{n_params} params, expected {PARAMS}")
    print(f"model: vit, 7 layers, hidden 384, 12 heads, {n_params} params, "
          f"{cfg.precision}")

    shutil.rmtree(WORK, ignore_errors=True)
    ckpt = os.path.join(WORK, "ckpt")
    save_checkpoint(ckpt, {"params": model.state_dict()}, cfg)
    art = export_inference(ckpt, os.path.join(WORK, "art"), device="cuda")

    plain, _ = get_model(cfg.replace(pallas_kernel="einsum"), device="cuda")
    plain.load_state_dict(model.state_dict())
    plain.eval().requires_grad_(False)
    dtype = torch_dtype(cfg)

    def plain_logits(imgs):
        with torch.inference_mode():
            x = normalize(torch.from_numpy(imgs).cuda(), cfg.mean, cfg.std)
            return plain(x.to(dtype)).float().cpu().numpy()

    srv = make_http_server(art, port=0, device="cuda")
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        if _get(f"{base}/healthz") != {"ok": True}:
            raise AssertionError("/healthz")
        meta = _get(f"{base}/meta")
        if meta["model_name"] != "vit" or meta["output"] != "float32[b,10]":
            raise AssertionError(f"/meta: {meta}")
        print(f"/healthz ok; /meta: device {meta['device']}, "
              f"{meta['bytes']} bytes of weights")

        rng = np.random.default_rng(0)
        batches = [rng.integers(0, 256, (B, 32, 32, 3), dtype=np.uint8)
                   for _, B in REQUESTS]
        responses, per_request = [], []
        for (kind, _), imgs in zip(REQUESTS, batches):
            before = fused_attention.launches
            responses.append(_post(f"{base}/predict", kind, imgs))
            per_request.append(fused_attention.launches - before)
        launches = fused_attention.launches

        for (kind, B), imgs, resp, n in zip(REQUESTS, batches, responses,
                                            per_request):
            logits = np.asarray(resp["logits"], np.float64)
            if logits.shape != (B, cfg.num_classes):
                raise AssertionError(f"logits shape {logits.shape}")
            if not np.array_equal(logits, logits.astype(np.float32)):
                raise AssertionError("logits are not float32 values")
            if not np.isfinite(logits).all():
                raise AssertionError("non-finite logits")
            if resp["pred"] != logits.argmax(-1).tolist():
                raise AssertionError("pred != argmax(logits)")
            if n != cfg.num_layers:
                raise AssertionError(
                    f"{n} kernel launches for one request, expected "
                    f"{cfg.num_layers}")
            want = plain_logits(imgs)
            np.testing.assert_allclose(logits, want, **LOGIT_TOL)
            agree = float((logits.argmax(-1) == want.argmax(-1)).mean())
            print(f"POST /predict {kind} B={B}: logits ({B}, 10) f32 finite, "
                  f"{n} kernel launches, max |served - plain| "
                  f"{np.abs(logits - want).max():.3e} within "
                  f"rtol={LOGIT_TOL['rtol']} atol={LOGIT_TOL['atol']}, "
                  f"top-1 agreement {agree:.3f}")
        print(f"main path: {launches} launches of mhsa_fwd over "
              f"{len(REQUESTS)} requests")

        served = ServingModel(art, device="cuda")
        for B in (1, 128):
            imgs = batches[[b for _, b in REQUESTS].index(B)]
            http = host_ms(lambda: _post(f"{base}/predict", "npy", imgs), 30)
            x = torch.from_numpy(imgs).cuda()

            def forward():
                with torch.inference_mode():
                    served.infer(x).cpu()

            local = host_ms(forward, 30)
            print(f"latency B={B}: POST /predict median {http:.3f} ms, "
                  f"in-process forward median {local:.3f} ms ({card})")
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=60)
    return launches


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this check needs a CUDA card")
    card = card_line()
    print(card)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("TF32 off for matmul and cuDNN: f32 references run in full f32")

    kernel = kernel_phase(card)
    kernel["launches"] = slice_phase(card)
    if kernel["launches"] < 1:
        raise AssertionError("the main path never launched mhsa_fwd")
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
