"""The wgmma backward pair's tiles, bf16 and f32 (TF32), measured on one
CUDA card.

    python3 tools/backward_choices.py [--only bf16|f32|f32s]

builds ``csrc/flash_bwd_dq.cu`` and ``csrc/flash_bwd_dkv.cu`` from copies
of ``vit_cifar_torch/csrc`` under ``build/backward_choices/``, one copy a
choice: the table of instances (``csrc/backward_tiles.cuh``) with one row
changed -- the dq kernel's key tile, or the dk/dv kernel's query tile, at
one padded head width; past the widest row the streamed rows' tile or
columns of the gradients a consumer holds; and the f32 instances'
DQ_F32 and DKV_F32 rows the same way -- and every build at once.  It
prints each build's ptxas registers and spills (or that it does not
build: tiles that miss shared memory fail a static_assert), checks that
each choice's gradients are within two bf16 steps (at their largest
value) of the repo's (f32: within 1e-5 of it, relative to the largest
value), and times it against the repo's own build in turns
(repo, choice, choice, repo; CUDA events) on the model's (B, H, T, D)
views at that width's shape: the pixel ViT's at 32 columns,
chip_smoke.py's head-dim shape (128, 8, 512, D) beyond (D = 64, 128 and
256, the last one of the column chunks), and for the streamed rows
(16, 2, 1024, 520), a head past the widest row; the f32 rows at the same
shapes in f32; the f32 streamed rows (DQ_F32_STREAMED, DKV_F32_STREAMED)
with half and twice the tile, the other column count and the other route,
each at (128, 8, 512, 192), (128, 8, 512, 256) and (16, 2, 1024, 520); and
the f32 streamed instances at 128 columns (the table without the 128-column
f32 row of the kernel) against that row at (128, 8, 512, 128).  The
table's tiles are chosen from this.  Prints the card's name and power
limit, a line a choice and shape, and one JSON object last.
"""

from __future__ import annotations

import ctypes
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from vit_cifar_torch.ops.cuda.build import (CSRC_DIR, NVCC_FLAGS,  # noqa: E402
                                            find_nvcc)
from vit_cifar_torch.ops.cuda.common import (  # noqa: E402
    BWD_STREAMED, DKV_F32_TILES, DKV_TILES, DQ_F32_TILES, DQ_TILES,
    F32_BWD_STREAMED, bind, launch_backward, library)
from vit_cifar_torch.ops.cuda.flash_attention import \
    flash_attention_lse  # noqa: E402

WORK = os.path.join(ROOT, "build", "backward_choices")
SHAPES = {32: (128, 12, 1025, 32), 64: (128, 8, 512, 64),
          128: (128, 8, 512, 128), 256: (128, 8, 512, 256),
          "streamed": (16, 2, 1024, 520)}
# (kernel, width, tile): the dq kernel's key tile or the dk/dv kernel's
# query tile at a width, the rest of the table as the repo has it; at
# width "streamed" a (tile, columns a consumer holds) of the streamed row
CHOICES = [("flash_bwd_dq", "streamed", (32, 128)),
           ("flash_bwd_dq", "streamed", (64, 64)),
           ("flash_bwd_dq", "streamed", (32, 256)),
           ("flash_bwd_dkv", "streamed", (32, 64)),
           ("flash_bwd_dkv", "streamed", (128, 64)),
           ("flash_bwd_dkv", "streamed", (64, 128)),
           ("flash_bwd_dq", 32, 64), ("flash_bwd_dq", 32, 128),
           ("flash_bwd_dq", 64, 32), ("flash_bwd_dq", 64, 96),
           ("flash_bwd_dq", 128, 32), ("flash_bwd_dq", 128, 96),
           ("flash_bwd_dq", 256, 16), ("flash_bwd_dq", 256, 64),
           ("flash_bwd_dkv", 32, 32), ("flash_bwd_dkv", 32, 128),
           ("flash_bwd_dkv", 64, 32), ("flash_bwd_dkv", 64, 128),
           ("flash_bwd_dkv", 128, 32), ("flash_bwd_dkv", 128, 128),
           ("flash_bwd_dkv", 256, 16), ("flash_bwd_dkv", 256, 64)]
# the f32 rows' neighbours, (kernel, "f32", (width, tile, bf16x3)): half
# and twice the tile where the kernel takes it (at most 64; tiles that miss
# shared memory fail their build on a static_assert and are reported so),
# and the row's tile on the other route of the gradient products (the
# tile's transpose, or its three bf16 terms: tiles of a multiple of 16, a
# consumer's columns whole bf16 atoms)
F32_CHOICES = [("flash_bwd_dq", "f32", (32, 32, 1)),
               ("flash_bwd_dq", "f32", (32, 64, 1)),
               ("flash_bwd_dq", "f32", (32, 48, 0)),
               ("flash_bwd_dq", "f32", (64, 32, 1)),
               ("flash_bwd_dq", "f32", (64, 16, 0)),
               ("flash_bwd_dq", "f32", (128, 32, 1)),
               ("flash_bwd_dq", "f32", (128, 8, 0)),
               ("flash_bwd_dkv", "f32", (32, 32, 1)),
               ("flash_bwd_dkv", "f32", (32, 16, 0)),
               ("flash_bwd_dkv", "f32", (64, 8, 0)),
               ("flash_bwd_dkv", "f32", (64, 32, 0)),
               ("flash_bwd_dkv", "f32", (128, 16, 0))]
# the f32 streamed rows' neighbours, (kernel, "f32s", (tile, columns a
# consumer holds, bf16x3)), timed at each of F32_STREAMED_SHAPES; and each
# kernel's streamed instance at 128 columns, (kernel, "f32s128", None)
F32_STREAMED_CHOICES = [("flash_bwd_dq", "f32s", (16, 64, 1)),
                        ("flash_bwd_dq", "f32s", (64, 64, 1)),
                        ("flash_bwd_dq", "f32s", (32, 32, 1)),
                        ("flash_bwd_dq", "f32s", (32, 64, 0)),
                        ("flash_bwd_dkv", "f32s", (16, 32, 1)),
                        ("flash_bwd_dkv", "f32s", (64, 32, 1)),
                        ("flash_bwd_dkv", "f32s", (32, 64, 1)),
                        ("flash_bwd_dkv", "f32s", (32, 32, 0)),
                        ("flash_bwd_dq", "f32s128", None),
                        ("flash_bwd_dkv", "f32s128", None)]
F32_STREAMED_SHAPES = [(128, 8, 512, 192), (128, 8, 512, 256),
                       (16, 2, 1024, 520)]
ROUNDS, ITERS = 3, 10


def build(kernel: str, width, tile):
    """Starts nvcc on ``kernel``'s source in a copy of the sources whose
    table has ``tile`` in that kernel's row at ``width`` (``"f32"``: tile
    is (width, tile, bf16x3) of the f32 row; ``"f32s"``: (tile, columns,
    bf16x3) of the f32 streamed row; ``"f32s128"``: the f32 row at 128
    columns taken out): (the library's path, the process)."""
    name = ("_".join(map(str, tile)) if width in ("streamed", "f32", "f32s")
            else tile)
    src = os.path.join(WORK, f"{kernel}_{width}_{name}")
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(CSRC_DIR, src)
    table = os.path.join(src, "backward_tiles.cuh")
    with open(table) as f:
        text = f.read()
    row = "DQ" if kernel == "flash_bwd_dq" else "DKV"
    if width == "streamed":
        text = re.sub(rf"^{row}_STREAMED\(\d+, \d+\)$",
                      f"{row}_STREAMED({tile[0]}, {tile[1]})", text,
                      flags=re.M)
    elif width == "f32":
        text = re.sub(rf"^{row}_F32\({tile[0]}, \d+, (\d+), [01]\)$",
                      rf"{row}_F32({tile[0]}, {tile[1]}, \1, {tile[2]})",
                      text, flags=re.M)
    elif width == "f32s":
        text = re.sub(rf"^{row}_F32_STREAMED\(\d+, \d+, [01]\)$",
                      f"{row}_F32_STREAMED({tile[0]}, {tile[1]}, {tile[2]})",
                      text, flags=re.M)
    elif width == "f32s128":  # 128 columns take the streamed row
        text = re.sub(rf"^{row}_F32\(128, \d+, \d+, [01]\)$", "", text,
                      flags=re.M)
    else:
        text = re.sub(rf"^{row}\({width}, \d+, (\d+)\)$",
                      rf"{row}({width}, {tile}, \1)", text, flags=re.M)
    with open(table, "w") as f:
        f.write(text)
    lib = os.path.join(src, f"{kernel}.so")
    return lib, subprocess.Popen(
        [find_nvcc(), *NVCC_FLAGS, "-o", lib, os.path.join(src,
                                                           f"{kernel}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def instance_report(report: str, instance: str) -> str:
    """ptxas's registers and spills of the wgmma instance ``instance``
    (``dq_kernel<32,64>``-style) in a build's report."""
    name, args = instance[:-1].split("<")
    mangled = re.compile(name + "I" + "".join(f"L[ib]{a}E"
                                             for a in args.split(",")))
    lines = report.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and mangled.search(line):
            regs = spill = ""
            for later in lines[i + 1:i + 6]:
                if "spill" in later:
                    spill = later.strip()
                elif "registers" in later:
                    regs = later.split(":", 1)[1].strip().split(",")[0]
            return f"{regs}; {spill}"
    return "not found"


def window_ms(fn) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    start.record()
    for _ in range(ITERS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / ITERS


def model_views(shape, gen, dtype=torch.bfloat16):
    B, H, T, D = shape
    return [torch.randn((B, T, H * D), generator=gen, device="cuda")
            .to(dtype).view(B, T, H, D).transpose(1, 2) for _ in range(3)]


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("backward_choices: needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card)
    only = sys.argv[sys.argv.index("--only") + 1] if "--only" in sys.argv \
        else None
    # --only f32s: the f32 streamed rows' choices alone
    choices = ((CHOICES if only is None or only == "bf16" else [])
               + (F32_CHOICES if only is None or only == "f32" else [])
               + (F32_STREAMED_CHOICES if only != "bf16" else []))
    os.makedirs(WORK, exist_ok=True)
    jobs = [(choice, *build(*choice)) for choice in choices]
    try:
        measure(card, jobs)
    finally:  # no compiler left running
        for _, _, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def run(kernel, lib, args):
    """``kernel``'s pass of ``lib`` on ``args``: its outputs."""
    q, k, v = args[:3]
    outs = ((torch.empty_like(q),) if kernel == "flash_bwd_dq"
            else (torch.empty_like(k), torch.empty_like(v)))
    launch_backward(kernel, *args[:6], outs, args[6], lib=lib)
    return outs


def time_streamed(card, kernel, kind, width, tile, report, lib,
                  inputs) -> list:
    """A streamed f32 choice (``"f32s"``: the streamed row's tile, columns
    and route; ``"f32s128"``: the streamed instance at 128 columns) checked
    against the repo's build (within 1e-5 of each gradient's largest value)
    and timed against it in turns at each of its shapes."""
    repo = F32_BWD_STREAMED[kind]
    if width == "f32s":
        shapes = F32_STREAMED_SHAPES
        instance = f"{kind}_split_stream_kernel<{','.join(map(str, tile))}>"
        label = f"streamed tile {tile} against the repo's {repo}"
    else:
        shapes = [SHAPES[128]]
        instance = (f"{kind}_split_stream_kernel<"
                    f"{','.join(str(int(x)) for x in repo)}>")
        cut = (DQ_F32_TILES if kind == "dq" else DKV_F32_TILES)[128]
        label = (f"the streamed instance {repo} at 128 columns against the "
                 f"repo's {kind.upper()}_F32 row {cut}")
    rows = []
    for shape in shapes:
        args = inputs[shape if width == "f32s" else ("f32", 128)]
        got, want = run(kernel, lib, args), run(kernel, library(kernel), args)
        diff = max((a - b).abs().max().item()
                   / (b.abs().max().item() * 1e-5)
                   for a, b in zip(got, want))
        if diff > 2:
            raise AssertionError(f"{kernel} {width}/{tile} {shape}: "
                                 f"{diff:.2f} 1e-5 steps from the repo's")
        times = {"repo": [], "choice": []}
        fns = {"repo": lambda: run(kernel, library(kernel), args),
               "choice": lambda: run(kernel, lib, args)}
        for _ in range(ROUNDS):
            for name in ("repo", "choice", "choice", "repo"):
                times[name].append(window_ms(fns[name]))
        med = {n: statistics.median(t) for n, t in times.items()}
        row = {"kernel": kernel, "width": width, "tile": tile,
               "repo_tile": repo, "shape": shape,
               "ptxas": instance_report(report, instance), "diff": diff,
               **{f"{n}_ms": t for n, t in times.items()},
               "choice_over_repo": med["choice"] / med["repo"]}
        rows.append(row)
        print(f"{kernel} {shape} f32: {label} (ptxas {row['ptxas']}) "
              f"{med['choice']:.4f} ms against {med['repo']:.4f} ms: "
              f"{row['choice_over_repo']:.3f} (medians of {2 * ROUNDS} "
              f"windows of {ITERS}); {diff:.2f} 1e-5 steps from the repo's "
              f"({card})", flush=True)
    return rows


def measure(card: str, jobs) -> None:
    """Checks and times each built choice against the repo's build."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    inputs = {}
    for dtype in (torch.bfloat16, torch.float32):
        for width, shape in SHAPES.items():
            if dtype == torch.float32 and width not in DQ_F32_TILES:
                continue
            B, H, T, D = shape
            q, k, v = model_views(shape, gen, dtype)
            scale = 1.0 / math.sqrt(H * D)
            out, lse = flash_attention_lse(q, k, v, scale)
            g = torch.randn((B, T, H, D), generator=gen,
                            device="cuda").to(dtype)
            key = width if dtype == torch.bfloat16 else ("f32", width)
            inputs[key] = (q, k, v, out, g, lse, scale)
    for shape in F32_STREAMED_SHAPES:
        B, H, T, D = shape
        q, k, v = model_views(shape, gen, torch.float32)
        scale = 1.0 / math.sqrt(H * D)
        out, lse = flash_attention_lse(q, k, v, scale)
        g = torch.randn((B, T, H, D), generator=gen, device="cuda")
        inputs[shape] = (q, k, v, out, g, lse, scale)

    result = {"card": card, "choices": []}
    for (kernel, width, tile), path, proc in jobs:
        report, _ = proc.communicate()
        if proc.returncode != 0:  # e.g. tiles that miss shared memory
            first = next((line for line in report.splitlines()
                          if "error" in line), report[-400:])
            print(f"{kernel} width {width} tile {tile} does not build: "
                  f"{first.strip()}", flush=True)
            result["choices"].append({"kernel": kernel, "width": width,
                                      "tile": tile, "built": False})
            continue
        if "wgmma.mma_async instructions are serialized" in report:
            print(f"{kernel} width {width} tile {tile}: ptxas serialised "
                  "its wgmmas; not timed")
            result["choices"].append({"kernel": kernel, "width": width,
                                      "tile": tile, "serialised": True})
            continue
        kind = "dq" if kernel == "flash_bwd_dq" else "dkv"
        lib = bind(ctypes.CDLL(path), kernel)
        if width in ("f32s", "f32s128"):
            result["choices"] += time_streamed(card, kernel, kind, width,
                                               tile, report, lib, inputs)
            continue
        f32 = width == "f32"
        if width == "streamed":
            repo_tile = BWD_STREAMED[kind]
            instance = f"{kind}_stream_kernel<{tile[0]},{tile[1]}>"
        elif f32:
            repo_tile, cols = (DQ_F32_TILES if kind == "dq"
                               else DKV_F32_TILES)[tile[0]]
            instance = (f"{kind}_split_kernel<{tile[0]},{tile[1]},{cols},"
                        f"{tile[2]}>")
        else:
            repo_tile, cols = (DQ_TILES if kind == "dq"
                               else DKV_TILES)[width]
            instance = f"{kind}_kernel<{width},{tile},{cols}>"
        args = inputs[("f32", tile[0]) if f32 else width]
        got, want = run(kernel, lib, args), run(kernel, library(kernel), args)
        # in bf16 steps (f32: in units of 1e-5) at each gradient's largest
        # value
        step = 1e-5 if f32 else 2.0 ** -7
        diff = max((a.float() - b.float()).abs().max().item()
                   / (b.float().abs().max().item() * step)
                   for a, b in zip(got, want))
        if diff > 2:
            raise AssertionError(f"{kernel} {width}/{tile}: {diff:.2f} "
                                 "steps from the repo's build")
        times = {"repo": [], "choice": []}
        fns = {"repo": lambda: run(kernel, library(kernel), args),
               "choice": lambda: run(kernel, lib, args)}
        for _ in range(ROUNDS):
            for name in ("repo", "choice", "choice", "repo"):
                times[name].append(window_ms(fns[name]))
        med = {n: statistics.median(t) for n, t in times.items()}
        shape = SHAPES[tile[0] if f32 else width]
        row = {"kernel": kernel, "width": width, "tile": tile,
               "repo_tile": repo_tile, "shape": shape,
               "ptxas": instance_report(report, instance),
               "diff": diff, **{f"{n}_ms": t for n, t in times.items()},
               "choice_over_repo": med["choice"] / med["repo"]}
        result["choices"].append(row)
        print(f"{kernel} {shape} {'f32' if f32 else 'bf16'}: tile {tile} "
              f"(ptxas {row['ptxas']}) {med['choice']:.4f} ms against the "
              f"repo's {repo_tile} {med['repo']:.4f} ms: "
              f"{row['choice_over_repo']:.3f} (medians of {2 * ROUNDS} "
              f"windows of {ITERS}); {diff:.2f} {'1e-5' if f32 else 'bf16'}"
              f" steps from the repo's ({card})", flush=True)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
