"""A/B of two checkouts of the PyTorch port on one CUDA card, in turns.

    python3 tools/torch_ab.py A_DIR B_DIR [--rounds 2] [--only flagship]

runs A, B, B, A (per round) in fresh processes, each importing
``vit_cifar_torch`` from its own checkout and building its kernels there, and
prints one JSON line per run and a table of medians, with each side's
least and most.  Both sides are measured by the helpers of this
checkout's ``chip_smoke.py`` (``cuda_ms``, ``device_ms``,
``training_setup``, ``profile_steps``), so that only the package
differs.  Each run measures, in bf16:

- the tiled kernels (forward, forward with lse, dq, dk/dv) at the pixel
  model's (128, 12, 1025, 32) and at (128, 8, 512, 128), and the whole-head
  forward with and without lse and the tiled kernels at the flagship's
  (128, 12, 65, 32): CUDA-event means over windows of launches and, under
  torch.profiler, device ms a call, and at (128, 12, 65, 32) the host
  microseconds a forward call costs on contiguous inputs; and the
  forwards and the tiled dq and dk/dv passes on the model's transposed
  views (the pixel shape's tiled forwards, the flagship's whole-head ones;
  the passes with o and lse as the forward returns them and a (B, T, H,
  D) cotangent): device ms a call, any copies of the views included, and
  the host microseconds a call costs;
- the flagship training step (README recipe without AutoAugment, B=128):
  host ms a step (synchronized), and under torch.profiler the device
  activity a step, the kernels a step and the busy share against the
  unprofiled step; the attention kernels' device ms a step;
- the pixel-token training step (patch 32, T=1025, B=128): the same;
- heads past 512 columns (``wide``, only when asked for): both forwards
  and the tiled dq and dk/dv passes on the model's views at
  (16, 2, 1024, 512) and (16, 2, 1024, 520), the table's edge, and at
  (128, 8, 512, D) for D = 576, 640, 768 and 1040: CUDA-event means over
  windows of about 50 ms;
- f32 (``f32``, only when asked for): the forwards with and without lse
  (the tiled ones at the pixel model's shape, the whole-head ones and the
  tiled ones at the flagship's), the tiled dq and dk/dv passes and the
  pair on the model's f32 views at the pixel model's and the flagship's
  shapes (CUDA events over windows of about 50 ms; device ms and the
  host microseconds a call at T=65), and the flagship and pixel training
  steps under ``--precision 32`` as above;
- f32 past 128 columns (``f32wide``, only when asked for): the tiled
  and the whole-head forwards with and without lse (both on the streamed
  instance there), the dq and dk/dv passes and the pair on
  the model's f32 views at (128, 8, 512, 192), (128, 8, 512, 256),
  (16, 2, 1024, 520) and the wide-head model's (128, 2, 257, 192), each in
  turns with the library's f32 call (efficient attention with lse, SDPA,
  SDPA's backward on the backend it takes) by CUDA events, each call's
  max error, the library's too, against the plain f32 version, and each
  kernel's bound (``chip_smoke.bound``); and the
  wide-head model's training step under ``--precision 32`` (hidden 384 in
  2 heads at patch 16, T=257, 2 layers, B=128) as above.

``--only`` runs one of the parts (``kernels``, ``flagship``, ``pixel``,
``wide``, ``f32``, ``f32wide``), for more rounds of it in the same
time.  Every number
is the card's; the card's name and power limit are printed with them.  Work
files go to ``build/chip_smoke/``.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNEL_SHAPES = {"pixel": (128, 12, 1025, 32), "d128": (128, 8, 512, 128),
                 "flagship": (128, 12, 65, 32)}
WIDE_SHAPES = {"long512": (16, 2, 1024, 512), "long520": (16, 2, 1024, 520),
               **{f"d{D}": (128, 8, 512, D) for D in (576, 640, 768, 1040)}}
F32_WIDE_SHAPES = {"d192": (128, 8, 512, 192), "d256": (128, 8, 512, 256),
                   "long520": (16, 2, 1024, 520), "wide": (128, 2, 257, 192)}


def _smoke():
    """This checkout's ``chip_smoke.py``, loaded by its path: its
    ``vit_cifar_torch`` imports resolve to the checkout under test."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _kernel_times(smoke, torch) -> dict:
    from vit_cifar_torch.ops.cuda.attention import (fused_attention,
                                                    fused_attention_lse)
    from vit_cifar_torch.ops.cuda.flash_attention import (
        flash_attention, flash_attention_lse, flash_tiled_bwd_dkv,
        flash_tiled_bwd_dq)

    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for tag, shape in KERNEL_SHAPES.items():
        B, H, T, D = shape
        scale = 1.0 / (H * D) ** 0.5
        q, k, v = (torch.randn(shape, generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(3))
        g = torch.randn((B, T, H, D), generator=gen,
                        device="cuda").to(torch.bfloat16)
        iters = 100 if T <= 65 else 10
        o, lse = flash_attention_lse(q, k, v, scale)
        args = (q, k, v, o, g, lse, scale)
        fns = {"flash_fwd": lambda: flash_attention(q, k, v, scale),
               "flash_fwd_lse": lambda: flash_attention_lse(q, k, v, scale),
               "flash_bwd_dq_tiled": lambda: flash_tiled_bwd_dq(*args),
               "flash_bwd_dkv_tiled": lambda: flash_tiled_bwd_dkv(*args)}
        if tag == "flagship":
            fns = {"mhsa_fwd": lambda: fused_attention(q, k, v, scale),
                   "mhsa_fwd_lse": lambda: fused_attention_lse(q, k, v, scale),
                   **fns}
        for name, fn in fns.items():
            out[f"{name} {tag}"] = smoke.cuda_ms(fn, iters, 5)
            out[f"{name} {tag} device"] = smoke.device_ms(fn)[0]
            if tag == "flagship" and "fwd" in name:
                # the host's cost of a call on contiguous inputs
                out[f"{name} {tag} host_us"] = smoke.host_us(fn)
    # the forwards and the backward passes on the model's views, (B, H, T,
    # D) transposes of its (B, T, H, D) projections, as the attention
    # module and its Function call them: the call's device time (whatever
    # copies it makes included) and its host microseconds
    for tag in ("pixel", "flagship"):
        shape = KERNEL_SHAPES[tag]
        B, H, T, D = shape
        scale = 1.0 / (H * D) ** 0.5
        q, k, v = smoke.model_views(shape, gen)
        o, lse = flash_attention_lse(q, k, v, scale)
        g = torch.randn((B, T, H, D), generator=gen,
                        device="cuda").to(torch.bfloat16)
        args = (q, k, v, o, g, lse, scale)
        fns = {"flash_fwd": lambda: flash_attention(q, k, v, scale),
               "flash_fwd_lse": lambda: flash_attention_lse(q, k, v, scale)}
        if tag == "flagship":
            fns = {"mhsa_fwd": lambda: fused_attention(q, k, v, scale),
                   "mhsa_fwd_lse": lambda: fused_attention_lse(q, k, v,
                                                               scale)}
        fns["flash_bwd_dq_tiled"] = lambda: flash_tiled_bwd_dq(*args)
        fns["flash_bwd_dkv_tiled"] = lambda: flash_tiled_bwd_dkv(*args)
        for name, fn in fns.items():
            out[f"{name} {tag} views device"] = smoke.device_ms(fn)[0]
            out[f"{name} {tag} views host_us"] = smoke.host_us(fn)
    return out


def _wide_times(smoke, torch) -> dict:
    """ms a call of both forwards and of the dq and dk/dv passes on the
    model's views at ``WIDE_SHAPES``, by CUDA events over windows of about
    50 ms."""
    from vit_cifar_torch.ops.cuda.attention import fused_attention
    from vit_cifar_torch.ops.cuda.flash_attention import (
        flash_attention, flash_attention_lse, flash_tiled_bwd_dkv,
        flash_tiled_bwd_dq)

    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for tag, shape in WIDE_SHAPES.items():
        B, H, T, D = shape
        scale = 1.0 / (H * D) ** 0.5
        q, k, v = smoke.model_views(shape, gen)
        o, lse = flash_attention_lse(q, k, v, scale)
        g = torch.randn((B, T, H, D), generator=gen,
                        device="cuda").to(torch.bfloat16)
        args = (q, k, v, o, g, lse, scale)
        fns = {"flash_fwd": lambda: flash_attention(q, k, v, scale),
               "mhsa_fwd": lambda: fused_attention(q, k, v, scale),
               "flash_bwd_dq_tiled": lambda: flash_tiled_bwd_dq(*args),
               "flash_bwd_dkv_tiled": lambda: flash_tiled_bwd_dkv(*args)}
        for name, fn in fns.items():
            iters = max(2, min(50, round(50 / smoke.cuda_ms(fn, 1, 1))))
            out[f"{name} {tag}"] = smoke.cuda_ms(fn, iters, 1)
        del q, k, v, o, lse, g, args, fns
        torch.cuda.empty_cache()
    return out


def _f32_times(smoke, torch) -> dict:
    """ms a call of the f32 forwards with and without lse (flash_fwd at the
    pixel model's shape; mhsa_fwd and flash_fwd at the flagship's), of the
    f32 dq and dk/dv passes and of the pair on the model's f32 views (o
    and lse as the f32 forward returns them, a (B, T, H, D) cotangent) at
    both shapes: CUDA events over windows of about 50 ms, and device ms and
    host microseconds a call at T=65."""
    from vit_cifar_torch.ops.cuda.attention import (fused_attention,
                                                    fused_attention_lse)
    from vit_cifar_torch.ops.cuda.flash_attention import (
        flash_attention, flash_attention_lse, flash_tiled_bwd_dkv,
        flash_tiled_bwd_dq)

    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for tag in ("pixel", "flagship"):
        B, H, T, D = shape = KERNEL_SHAPES[tag]
        scale = 1.0 / (H * D) ** 0.5
        q, k, v = (t.float() for t in smoke.model_views(shape, gen))
        o, lse = flash_attention_lse(q, k, v, scale)
        g = torch.randn((B, T, H, D), generator=gen, device="cuda")
        args = (q, k, v, o, g, lse, scale)
        fns = {"f32 flash_fwd": lambda: flash_attention(q, k, v, scale),
               "f32 flash_fwd_lse": lambda: flash_attention_lse(q, k, v,
                                                                scale)}
        if tag == "flagship":
            fns["f32 mhsa_fwd"] = lambda: fused_attention(q, k, v, scale)
            fns["f32 mhsa_fwd_lse"] = lambda: fused_attention_lse(q, k, v,
                                                                  scale)
        fns.update({
               "f32 flash_bwd_dq_tiled": lambda: flash_tiled_bwd_dq(*args),
               "f32 flash_bwd_dkv_tiled": lambda: flash_tiled_bwd_dkv(*args),
               "f32 pair": lambda: (flash_tiled_bwd_dq(*args),
                                    flash_tiled_bwd_dkv(*args))})
        for name, fn in fns.items():
            iters = max(2, min(100, round(50 / smoke.cuda_ms(fn, 1, 1))))
            out[f"{name} {tag}"] = smoke.cuda_ms(fn, iters, 2)
            if T <= 65:
                out[f"{name} {tag} device"] = smoke.device_ms(fn)[0]
                # the host's cost of a call on the model's views
                out[f"{name} {tag} host_us"] = smoke.host_us(fn)
        del q, k, v, o, lse, g, args, fns
        torch.cuda.empty_cache()
    return out


def _f32_wide_times(smoke, torch) -> dict:
    """ms a call of the f32 tiled and whole-head forwards with and without
    lse, of the f32 dq and dk/dv passes and of the pair on the model's f32
    views at ``F32_WIDE_SHAPES``, each in turns with the library's f32 call
    where one computes the same (``chip_smoke.library_f32``; SDPA in f32
    for the inference forwards), by CUDA events over windows of about 50
    ms; the max error of each call, the library's too, against the plain
    f32 versions; and each kernel's bound."""
    from vit_cifar_torch.ops.cuda.attention import (fused_attention,
                                                    fused_attention_lse)
    from vit_cifar_torch.ops.cuda.flash_attention import (
        flash_attention, flash_attention_lse, flash_attention_lse_reference,
        flash_tiled_bwd_dkv, flash_tiled_bwd_dkv_reference,
        flash_tiled_bwd_dq, flash_tiled_bwd_dq_reference)

    F = torch.nn.functional
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for tag, shape in F32_WIDE_SHAPES.items():
        B, H, T, D = shape
        scale = 1.0 / (H * D) ** 0.5
        q, k, v = smoke.model_views(shape, gen, torch.float32)
        o, lse = flash_attention_lse(q, k, v, scale)
        g = torch.randn((B, T, H, D), generator=gen, device="cuda")
        args = (q, k, v, o, g, lse, scale)
        want_o, want_lse = flash_attention_lse_reference(q, k, v, scale)
        want = (flash_tiled_bwd_dq_reference(*args),
                *flash_tiled_bwd_dkv_reference(*args))
        lib = smoke.library_f32(shape, q, k, v, g, scale,
                                (want_o, want_lse, *want))
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q, k, v, scale=scale).transpose(1, 2)
        pair = lambda: (flash_tiled_bwd_dq(*args),  # noqa: E731
                        *flash_tiled_bwd_dkv(*args))
        got = pair()
        errs = {"f32 flash_fwd": smoke._max_err(
                    (flash_attention(q, k, v, scale),), (want_o,)),
                "f32 flash_fwd_lse": smoke._max_err(
                    flash_attention_lse(q, k, v, scale), (want_o, want_lse)),
                "f32 mhsa_fwd": smoke._max_err(
                    (fused_attention(q, k, v, scale),), (want_o,)),
                "f32 mhsa_fwd_lse": smoke._max_err(
                    fused_attention_lse(q, k, v, scale), (want_o, want_lse)),
                "f32 flash_bwd_dq_tiled": smoke._max_err(got[:1], want[:1]),
                "f32 flash_bwd_dkv_tiled": smoke._max_err(got[1:], want[1:]),
                "f32 pair": smoke._max_err(got, want),
                "library fwd": smoke._max_err((sdpa(),), (want_o,)),
                "library fwd_lse": lib["errs"]["fwd_lse"],
                "library pair": lib["errs"]["bwd_pair"]}
        del got, want, want_o, want_lse
        fns = {"f32 flash_fwd": (lambda: flash_attention(q, k, v, scale),
                                 sdpa),
               "f32 flash_fwd_lse": (
                   lambda: flash_attention_lse(q, k, v, scale),
                   lib["fwd_lse"]),
               "f32 mhsa_fwd": (lambda: fused_attention(q, k, v, scale),
                                sdpa),
               "f32 mhsa_fwd_lse": (
                   lambda: fused_attention_lse(q, k, v, scale),
                   lib["fwd_lse"]),
               "f32 flash_bwd_dq_tiled": (lambda: flash_tiled_bwd_dq(*args),
                                          None),
               "f32 flash_bwd_dkv_tiled": (
                   lambda: flash_tiled_bwd_dkv(*args), None),
               "f32 pair": (pair, lib["bwd_pair"])}
        for name, (fn, library) in fns.items():
            iters = max(2, min(100, round(50 / smoke.cuda_ms(fn, 1, 1))))
            if library is None:
                out[f"{name} {tag}"] = smoke.cuda_ms(fn, iters, 2)
            else:
                ms = smoke.in_turns({"kernel": fn, "library": library},
                                    rounds=1, iters=iters)
                out[f"{name} {tag}"] = ms["kernel"]
                out[f"{name} {tag} library"] = ms["library"]
        out.update({f"{name} {tag} err": e for name, e in errs.items()})
        for name in fns:
            if name != "f32 pair":
                kernel = name.split()[1]
                out[f"{name} {tag} bound"] = smoke.bound(
                    kernel, shape, torch.float32)["bound_ms"]
        print(f"f32 past 128 columns {tag} {shape}: the library's pair on "
              f"SDPA's {lib['backend']} backend", file=sys.stderr)
        del q, k, v, o, lse, g, args, lib, fns
        torch.cuda.empty_cache()
    return out


def _train(smoke, torch, card: str, patch: int, steps: int,
           n_prof: int, precision: str | None = None, **cfg_kw) -> dict:
    cfg = smoke.flagship_cfg(patch=patch, **cfg_kw, **(
        {"precision": precision} if precision else {}))
    _, x, y, _, state, train_step, perm = smoke.training_setup(cfg)
    box = [state]

    def step(i):
        box[0], _ = train_step(box[0], x, y, perm, i)

    warm = 10 if patch == 8 else 3
    for i in range(warm):
        step(i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(steps):
        step(warm + i)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / steps
    prof = smoke.profile_steps(lambda i: step(warm + steps + i), n_prof,
                               f"ab_trace_{os.getpid()}.json", step_ms, card)
    attention = {}
    for key, ms in prof.pop("by_kernel").items():
        # the attention kernels: the CUDA-core ones and the wgmma
        # instances (fwd_*, dq_*, dkv_*: bf16 and the f32 split kernels)
        if re.search(r"mhsa|flash_|\b(fwd|dq|dkv)_\w*kernel", key):
            found = re.search(r"\w+_kernel", key)
            name = found.group(0) if found else key[:60]
            attention[name] = attention.get(name, 0.0) + ms
    return {"step_ms": step_ms, **prof, "attention_ms": attention}


def worker(checkout: str, only: str | None) -> None:
    sys.path.insert(0, os.path.abspath(checkout))
    import torch
    import vit_cifar_torch
    from vit_cifar_torch.ops.cuda.build import CSRC_DIR, build_libraries

    where = os.path.dirname(os.path.abspath(vit_cifar_torch.__file__))
    if not where.startswith(os.path.abspath(checkout)):
        raise SystemExit(f"imported vit_cifar_torch from {where}")
    smoke = _smoke()
    card = smoke.card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    build_libraries(sorted(p.stem for p in CSRC_DIR.glob("*.cu")))
    build_s = time.perf_counter() - t0
    parts = {"kernels_ms": lambda: _kernel_times(smoke, torch),
             "flagship": lambda: _train(smoke, torch, card, 8, 30, 20),
             "pixel": lambda: _train(smoke, torch, card, 32, 8, 3),
             "wide_ms": lambda: _wide_times(smoke, torch),
             "f32_ms": lambda: _f32_times(smoke, torch),
             "f32 flagship": lambda: _train(smoke, torch, card, 8, 30, 10,
                                            "32"),
             "f32 pixel": lambda: _train(smoke, torch, card, 32, 4, 2,
                                         "32"),
             "f32wide_ms": lambda: _f32_wide_times(smoke, torch),
             # the wide-head model: hidden 384 in 2 heads, T=257
             "f32wide step": lambda: _train(
                 smoke, torch, card, smoke.WIDE_F32_PATCH, 10, 3, "32",
                 num_layers=smoke.WIDE_LAYERS, head=2)}
    result = {"checkout": checkout, "build_s": build_s}
    for part, run in parts.items():
        asked = part.removesuffix("_ms").split()[0]
        if only == asked or (only is None
                             and asked not in ("wide", "f32", "f32wide")):
            result[part] = run()
    print(json.dumps(result))


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("a")
    parser.add_argument("b", nargs="?")
    parser.add_argument("--rounds", type=int, default=1)
    parser.add_argument("--worker", action="store_true")
    parser.add_argument("--only",
                        choices=("kernels", "flagship", "pixel", "wide",
                                 "f32", "f32wide"))
    args = parser.parse_args()
    if args.worker:
        worker(args.a, args.only)
        return
    # the workers run from this checkout's root: the caller's paths, resolved
    args.a, args.b = (os.path.abspath(c) if c else c for c in (args.a, args.b))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_ab: torch.cuda.is_available() is false")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    runs = {args.a: [], args.b: []}
    for _ in range(args.rounds):
        for checkout in (args.a, args.b, args.b, args.a):
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), checkout,
                 "--worker"] + (["--only", args.only] if args.only else []),
                capture_output=True, text=True, cwd=ROOT)
            if proc.returncode != 0:
                raise SystemExit(f"{checkout} failed:\n{proc.stderr[-4000:]}")
            line = proc.stdout.strip().splitlines()[-1]
            print(line, flush=True)
            runs[checkout].append(json.loads(line))

    def med(checkout, get):
        return statistics.median(get(r) for r in runs[checkout])

    first = runs[args.a][0]
    rows = [(k, lambda r, p=part, k=k: r[p].get(k, float("nan")))
            for part in ("kernels_ms", "wide_ms", "f32_ms", "f32wide_ms")
            for k in first.get(part, {})]
    for model in ("flagship", "pixel", "f32 flagship", "f32 pixel",
                  "f32wide step"):
        for key in ("step_ms", "device_ms", "busy", "kernels"):
            if model in first:
                rows.append((f"{model} {key}",
                             lambda r, m=model, k=key: r[m][k]))
    def spread(checkout, get):
        got = [get(r) for r in runs[checkout]]
        return f"({min(got):.4f}-{max(got):.4f})"

    print(f"median of {2 * args.rounds} runs each, (least-most) ({card}):")
    for name, get in rows:
        a, b = med(args.a, get), med(args.b, get)
        print(f"  {name:32s} {args.a}: {a:10.4f} {spread(args.a, get)}   "
              f"{args.b}: {b:10.4f} {spread(args.b, get)}   b/a {b / a:.3f}")


if __name__ == "__main__":
    main()
