"""The bf16 wgmma backward pair's tiles, measured on one CUDA card.

    python3 tools/backward_choices.py

builds ``csrc/flash_bwd_dq.cu`` and ``csrc/flash_bwd_dkv.cu`` from copies
of ``vit_cifar_torch/csrc`` under ``build/backward_choices/``, one copy a
choice: the table of instances (``csrc/backward_tiles.cuh``) with one row
changed -- the dq kernel's key tile, or the dk/dv kernel's query tile, at
one padded head width; past the widest row the streamed rows' tile or
columns of the gradients a consumer holds -- and every build at once.  It
prints each build's ptxas registers and spills (or that it does not
build: tiles that miss shared memory fail a static_assert), checks that
each choice's gradients are within two bf16 steps (at their largest
value) of the repo's, and times it against the repo's own build in turns
(repo, choice, choice, repo; CUDA events) on the model's (B, H, T, D)
views at that width's shape: the pixel ViT's at 32 columns,
chip_smoke.py's head-dim shape (128, 8, 512, D) beyond (D = 64, 128 and
256, the last one of the column chunks), and for the streamed rows
(16, 2, 1024, 520), a head past the widest row.  The table's tiles are
chosen from this.  Prints the card's name and power limit, a line a
choice, and one JSON object last.
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
    BWD_STREAMED, DKV_TILES, DQ_TILES, bind, launch_backward, library)
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
ROUNDS, ITERS = 3, 10


def build(kernel: str, width: int, tile: int):
    """Starts nvcc on ``kernel``'s source in a copy of the sources whose
    table has ``tile`` in that kernel's row at ``width``: (the library's
    path, the process)."""
    name = "_".join(map(str, tile)) if width == "streamed" else tile
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
    mangled = name + "I" + "".join(f"Li{a}E" for a in args.split(","))
    lines = report.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and mangled in line:
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


def model_views(shape, gen):
    B, H, T, D = shape
    return [torch.randn((B, T, H * D), generator=gen, device="cuda")
            .to(torch.bfloat16).view(B, T, H, D).transpose(1, 2)
            for _ in range(3)]


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("backward_choices: needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card)
    os.makedirs(WORK, exist_ok=True)
    jobs = [(choice, *build(*choice)) for choice in CHOICES]
    try:
        measure(card, jobs)
    finally:  # no compiler left running
        for _, _, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def measure(card: str, jobs) -> None:
    """Checks and times each built choice against the repo's build."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    inputs = {}
    for width, shape in SHAPES.items():
        B, H, T, D = shape
        q, k, v = model_views(shape, gen)
        scale = 1.0 / math.sqrt(H * D)
        out, lse = flash_attention_lse(q, k, v, scale)
        g = torch.randn((B, T, H, D), generator=gen,
                        device="cuda").to(torch.bfloat16)
        inputs[width] = (q, k, v, out, g, lse, scale)

    def run(kernel, lib, args):
        q, k, v = args[:3]
        outs = ((torch.empty_like(q),) if kernel == "flash_bwd_dq"
                else (torch.empty_like(k), torch.empty_like(v)))
        launch_backward(kernel, *args[:6], outs, args[6], lib=lib)
        return outs

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
            continue
        kind = "dq" if kernel == "flash_bwd_dq" else "dkv"
        if width == "streamed":
            repo_tile = BWD_STREAMED[kind]
            instance = f"{kind}_stream_kernel<{tile[0]},{tile[1]}>"
        else:
            repo_tile, cols = (DQ_TILES if kind == "dq"
                               else DKV_TILES)[width]
            instance = f"{kind}_kernel<{width},{tile},{cols}>"
        lib = bind(ctypes.CDLL(path), kernel)
        args = inputs[width]
        got, want = run(kernel, lib, args), run(kernel, library(kernel), args)
        # in bf16 steps at each gradient's largest value
        diff = max((a.float() - b.float()).abs().max().item()
                   / (b.float().abs().max().item() * 2.0 ** -7)
                   for a, b in zip(got, want))
        if diff > 2:
            raise AssertionError(f"{kernel} {width}/{tile}: {diff:.2f} bf16 "
                                 "steps from the repo's build")
        times = {"repo": [], "choice": []}
        fns = {"repo": lambda: run(kernel, library(kernel), args),
               "choice": lambda: run(kernel, lib, args)}
        for _ in range(ROUNDS):
            for name in ("repo", "choice", "choice", "repo"):
                times[name].append(window_ms(fns[name]))
        med = {n: statistics.median(t) for n, t in times.items()}
        row = {"kernel": kernel, "width": width, "tile": tile,
               "repo_tile": repo_tile, "shape": SHAPES[width],
               "ptxas": instance_report(report, instance),
               "diff": diff, **{f"{n}_ms": t for n, t in times.items()},
               "choice_over_repo": med["choice"] / med["repo"]}
        result["choices"].append(row)
        print(f"{kernel} {SHAPES[width]} bf16: tile {tile} (ptxas "
              f"{row['ptxas']}) {med['choice']:.4f} ms against the repo's "
              f"{repo_tile} {med['repo']:.4f} ms: "
              f"{row['choice_over_repo']:.3f} (medians of {2 * ROUNDS} "
              f"windows of {ITERS}); {diff:.2f} bf16 steps from the repo's "
              f"({card})", flush=True)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
