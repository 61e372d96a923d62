"""The bf16 wgmma forward's free choices, measured on one CUDA card.

    python3 tools/forward_choices.py

builds ``csrc/flash_fwd.cu`` twice from copies of ``vit_cifar_torch/csrc``
under ``build/forward_choices/``: once with every row of the table of
instances (``csrc/forward_tiles.cuh``) set to ping-pong (the two consumer
warpgroups take turns at the tensor cores) and once with none.  It then
times the two builds in turns (A, B, B, A; CUDA events) on the model's
(B, H, T, D) views of (B, T, H, D) projections at each padded head width
of the table, checks that both give the same output, and times what the
ragged last query and key tiles of the pixel ViT's T=1025 (8 * 128 + 1)
cost against T=1024 with the repo's own build.  The table's ping-pong
column is chosen from this.  Prints the card's name and power limit, a
line a measurement, and one JSON object last.
"""

from __future__ import annotations

import ctypes
import json
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
from vit_cifar_torch.ops.cuda.common import tma_strides  # noqa: E402
from vit_cifar_torch.ops.cuda.flash_attention import \
    flash_attention  # noqa: E402

WORK = os.path.join(ROOT, "build", "forward_choices")
# one shape a padded head width: the pixel ViT's at 32 columns, the
# head-dim shapes of chip_smoke.py beyond
SHAPES = [(128, 12, 1025, 32), (128, 8, 512, 64), (128, 8, 512, 128),
          (128, 8, 512, 192), (128, 8, 512, 256)]
ROUNDS, ITERS = 4, 10


def build(pingpong: int) -> tuple[str, subprocess.Popen]:
    """Starts nvcc on flash_fwd.cu in a copy of the sources whose table
    rows all ask for ``pingpong``: (the library's path, the process)."""
    src = os.path.join(WORK, f"pingpong{pingpong}")
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(CSRC_DIR, src)
    table = os.path.join(src, "forward_tiles.cuh")
    with open(table) as f:
        text = f.read()
    text = re.sub(r"^TILED\((\d+), (\d+), [01]\)$",
                  rf"TILED(\1, \2, {pingpong})", text, flags=re.M)
    with open(table, "w") as f:
        f.write(text)
    return os.path.join(src, "flash_fwd.so"), subprocess.Popen(
        [find_nvcc(), *NVCC_FLAGS, "-o", os.path.join(src, "flash_fwd.so"),
         os.path.join(src, "flash_fwd.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def launcher(lib: ctypes.CDLL):
    """``flash_fwd`` of ``lib`` on bf16 views that TMA reads in place."""
    lib.flash_fwd.restype = ctypes.c_int

    def run(q, k, v, scale):
        B, H, T, D = q.shape
        out = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
        strides = (ctypes.c_longlong * 9)(
            *tma_strides(q), *tma_strides(k), *tma_strides(v))
        err = lib.flash_fwd(
            *(ctypes.c_void_p(t.data_ptr()) for t in (q, k, v, out)),
            ctypes.c_void_p(None), strides,
            *(ctypes.c_int(n) for n in (B, H, T, D)), ctypes.c_float(scale),
            ctypes.c_int(1),
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        if err != 0:
            raise RuntimeError(f"flash_fwd launch failed: cudaError {err}")
        return out
    return run


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


def in_turns(a, b) -> tuple[list, list]:
    """Windows of a and b in turns A, B, B, A, ``ROUNDS`` times."""
    times = ([], [])
    for _ in range(ROUNDS):
        for i in (0, 1, 1, 0):
            times[i].append(window_ms((a, b)[i]))
    return times


def model_views(shape, gen):
    B, H, T, D = shape
    return [torch.randn((B, T, H * D), generator=gen, device="cuda")
            .to(torch.bfloat16).view(B, T, H, D).transpose(1, 2)
            for _ in range(3)]


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("forward_choices: needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card)
    os.makedirs(WORK, exist_ok=True)
    jobs = [build(pp) for pp in (1, 0)]
    libs = []
    for path, proc in jobs:
        report, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed:\n{report}")
        if "wgmma.mma_async instructions are serialized" in report:
            raise SystemExit(f"ptxas serialised wgmmas:\n{report}")
        libs.append(launcher(ctypes.CDLL(path)))
    on, off = libs
    gen = torch.Generator(device="cuda").manual_seed(0)
    result = {"card": card, "pingpong": {}, "ragged": {}}
    for shape in SHAPES:
        q, k, v = model_views(shape, gen)
        scale = 1.0 / (shape[1] * shape[3]) ** 0.5
        if not torch.equal(on(q, k, v, scale), off(q, k, v, scale)):
            raise AssertionError(f"{shape}: the two builds disagree")
        t_on, t_off = in_turns(lambda: on(q, k, v, scale),
                               lambda: off(q, k, v, scale))
        med_on, med_off = statistics.median(t_on), statistics.median(t_off)
        result["pingpong"][str(shape)] = {
            "on_ms": t_on, "off_ms": t_off, "off_over_on": med_off / med_on}
        print(f"flash_fwd {shape} bf16: ping-pong {med_on:.4f} ms "
              f"({min(t_on):.4f}-{max(t_on):.4f}), none {med_off:.4f} ms "
              f"({min(t_off):.4f}-{max(t_off):.4f}): none/ping-pong "
              f"{med_off / med_on:.3f} (median of {2 * ROUNDS} windows of "
              f"{ITERS}, in turns; {card})")
        del q, k, v
    q, k, v = model_views(SHAPES[0], gen)
    q4, k4, v4 = (t[:, :, :-1] for t in (q, k, v))
    scale = 1.0 / (SHAPES[0][1] * SHAPES[0][3]) ** 0.5
    t25, t24 = in_turns(lambda: flash_attention(q, k, v, scale),
                        lambda: flash_attention(q4, k4, v4, scale))
    m25, m24 = statistics.median(t25), statistics.median(t24)
    result["ragged"] = {"T1025_ms": t25, "T1024_ms": t24}
    print(f"flash_fwd (128, 12, T, 32) bf16, the repo's build: T=1025 "
          f"{m25:.4f} ms ({min(t25):.4f}-{max(t25):.4f}), T=1024 {m24:.4f} "
          f"ms ({min(t24):.4f}-{max(t24):.4f}): the ragged last tiles cost "
          f"{m25 / m24 - 1:.1%} ({card})")
    print(json.dumps(result))


if __name__ == "__main__":
    main()
