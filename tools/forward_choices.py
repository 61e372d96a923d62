"""The wgmma forward's free choices, bf16 and f32 (TF32), measured on one
CUDA card.

    python3 tools/forward_choices.py [--only bf16|f32|f32s]

builds ``csrc/flash_fwd.cu`` from copies of ``vit_cifar_torch/csrc`` under
``build/forward_choices/``, every build at once.  First the column-chunk
rows of the table of instances (``csrc/forward_tiles.cuh``, the CHUNKED
rows past 256 columns): for each, builds whose table holds that row
alone, changed in one choice -- half and twice its key tile, chunks of o
of 128, 192 or 256 columns, ping-pong (the two consumer warpgroups take
turns at the tensor cores) flipped -- and, at 192 and 256 columns, the
one-pass row replaced by chunks of 128 columns.  Past the table, rows of
16 keys and chunks of 256 columns at 576, 640 and 704 columns show where
q at full width and two stages of the ring stop fitting shared memory,
each against the repo's streamed instance there; and each streamed row
(``STREAMED``) alone, changed in one choice -- half and twice its key
tile, chunks of o of 128, 192 or 256 columns -- at the widths of 520,
576, 640, 768 and 1040 columns it takes.  A choice
whose tiles do not fit shared memory fails its build (a static_assert)
and is reported so.  Each built choice is checked within two bf16 steps
(at the largest value) of the repo's build and timed against it in
turns (repo, choice, choice, repo; CUDA events) at (128, 8, 512, width)
on the model's (B, H, T, D) views of (B, T, H, D) projections, with its
ptxas registers and spills.  Then two builds with every one-pass row set
to ping-pong and to none, timed the same way at each one-pass width and checked equal, and
what the ragged last query and key tiles of the pixel ViT's T=1025 (8 *
128 + 1) cost against T=1024 with the repo's own build.  The table's key
tiles, chunks and ping-pong columns are chosen from this.

The f32 rows (``FWD_F32``, ``--only f32``): each row alone changed in one
choice -- half and twice its key tile, and p.V on the other route (V's
three bf16 terms or its TF32 transpose) -- built, checked within two
units of 1e-5 (at the largest value) of the repo's build and timed
against it in turns on the model's f32 views at the row's shape: the
pixel ViT's (128, 12, 1025, 32) at 32 columns, (128, 8, 512, D) at 64
and 128; then, with the repo's build, mhsa_fwd's whole head as one key
tile against flash_fwd's tiled items at each width's last whole-head T
(device ms under torch.profiler: a window of events follows the host
there), at (128, 12, T, D).

The f32 streamed row past 128 columns (``FWD_F32_STREAMED``, ``--only
f32s``): the row changed in one choice -- half, 1.5 and twice its key tile,
and the other widths of o a consumer of 32, 64 and 128 columns -- built,
checked within two units of 1e-5 (at the largest value) of the repo's
build and timed against it in turns (a choice that spills registers is
reported with its ptxas line and not run) on the model's f32 views at
(128, 8, 512, 192), (128, 8, 512, 256), (16, 2, 1024, 520) and the
wide-head model's (128, 2, 257, 192); then the repo's build's device ms
by kernel at each shape (the split pass and the streamed kernel, by
torch.profiler).  Prints the card's name and power limit, a line a
measurement, and one JSON object last.
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
from vit_cifar_torch.ops.cuda.attention import \
    fused_attention  # noqa: E402
from vit_cifar_torch.ops.cuda.common import (  # noqa: E402
    F32_FWD_STREAMED, FWD_F32_TILES, PINGPONG, STREAMED, TILED_COLS,
    TILED_KEYS, WHOLE_F32_KEYS, WIDEST_FORWARD, library, readable,
    tma_strides)
from vit_cifar_torch.ops.cuda.flash_attention import \
    flash_attention  # noqa: E402

WORK = os.path.join(ROOT, "build", "forward_choices")
# one shape a one-pass width: the pixel ViT's at 32 columns, the head-dim
# shapes of chip_smoke.py beyond; the column-chunk choices at
# (128, 8, 512, width)
SHAPES = [(128, 12, 1025, 32), (128, 8, 512, 64), (128, 8, 512, 128),
          (128, 8, 512, 192), (128, 8, 512, 256)]
ROUNDS, ITERS = 4, 10


# the widths at which the streamed rows' choices are timed
STREAMED_WIDTHS = (520, 576, 640, 768, 1040)
# the f32 rows' shapes, by width
F32_SHAPES = {32: (128, 12, 1025, 32), 64: (128, 8, 512, 64),
              128: (128, 8, 512, 128)}


def f32_choices() -> list[tuple[int, tuple, str]]:
    """(width, (keys, cols, bf16x3), what) of each f32 choice: every
    FWD_F32 row with half and twice its key tile, and on the other route
    of p.V."""
    choices = []
    for width, (keys, cols, bf16x3) in FWD_F32_TILES.items():
        for n in (keys // 2, 2 * keys):
            choices.append((width, (n, cols, bf16x3), f"f32 key tile {n}"))
        choices.append((width, (keys, cols, not bf16x3),
                        "f32 p.V on V's " + ("TF32 transpose" if bf16x3
                                             else "three bf16 terms")))
    return choices


def build_f32(width: int, row: tuple) -> tuple[str, subprocess.Popen]:
    """Starts nvcc on a copy whose FWD_F32 row at ``width`` is (keys, cols,
    bf16x3) = row, the rest of the table as the repo has it."""
    keys, cols, bf16x3 = row
    return nvcc(copy_with_table(
        f"f32_{width}_{keys}_{cols}_{int(bf16x3)}",
        lambda text: re.sub(rf"^FWD_F32\({width}, \d+, \d+, [01]\)$",
                            f"FWD_F32({width}, {keys}, {cols}, "
                            f"{int(bf16x3)})", text, flags=re.M)))


# the f32 streamed row's shapes: chip_smoke.py's wide f32 shapes and the
# wide-head model's head at B=128
F32S_SHAPES = ((128, 8, 512, 192), (128, 8, 512, 256), (16, 2, 1024, 520),
               (128, 2, 257, 192))


def f32s_choices() -> list[tuple[tuple, str]]:
    """((keys, cols), what) of each choice of the f32 streamed row: half,
    1.5 and twice its key tile, and the other widths of o a consumer."""
    keys, cols = F32_FWD_STREAMED
    choices = [((n, cols), f"key tile {n}")
               for n in (keys // 2, keys * 3 // 2, 2 * keys)]
    choices += [((keys, c), f"{c} columns of o a consumer")
                for c in (32, 64, 128) if c != cols]
    return choices


def build_f32s(row: tuple) -> tuple[str, subprocess.Popen]:
    """Starts nvcc on a copy whose FWD_F32_STREAMED row is ``row``."""
    flags = ", ".join(str(x) for x in row)
    return nvcc(copy_with_table(
        "f32s_" + "_".join(str(x) for x in row),
        lambda text: re.sub(r"^FWD_F32_STREAMED\(.*\)$",
                            f"FWD_F32_STREAMED({flags})", text, flags=re.M)))


def chunk_choices() -> list[tuple[int, tuple, str]]:
    """(width, (keys, cols, pingpong), what) of each choice: every CHUNKED
    row's neighbours, the one-pass rows at 192 and 256 columns as chunks
    of 128 columns (64 keys, the 128-column row's tile), CHUNKED rows past
    the table's widest, and the streamed row's neighbours (pingpong None:
    a STREAMED row)."""
    choices = []
    for width, keys in TILED_KEYS.items():
        cols, pp = TILED_COLS[width], int(PINGPONG[width])
        if cols == width:
            if width in (192, 256):
                choices.append((width, (64, 128, pp),
                                "chunks of 128 columns, 64 keys"))
            continue
        for n in (keys // 2, 2 * keys):
            choices.append((width, (n, cols, pp), f"key tile {n}"))
        for c in (128, 192, 256):
            if c != cols:
                choices.append((width, (keys, c, pp),
                                f"chunks of {c} columns"))
        choices.append((width, (keys, cols, 1 - pp),
                        f"ping-pong {'on' if pp == 0 else 'off'}"))
    for width in (576, 640, 704):
        choices.append((width, (16, 256, 0), "past the table"))
    below = WIDEST_FORWARD
    for top, (keys, cols) in STREAMED.items():
        last = top == max(STREAMED)
        for width in STREAMED_WIDTHS:
            if not (below < width <= top or last and width > below):
                continue
            for n in (keys // 2, 2 * keys):
                choices.append((width, (n, cols, None),
                                f"streamed, key tile {n}"))
            for c in (128, 192, 256):
                if c != cols:
                    choices.append((width, (keys, c, None),
                                    f"streamed, chunks of {c} columns"))
        below = top
    return choices


def nvcc(src: str) -> tuple[str, subprocess.Popen]:
    """Starts nvcc on flash_fwd.cu in the copy of the sources ``src``:
    (the library's path, the process)."""
    return os.path.join(src, "flash_fwd.so"), subprocess.Popen(
        [find_nvcc(), *NVCC_FLAGS, "-o", os.path.join(src, "flash_fwd.so"),
         os.path.join(src, "flash_fwd.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def copy_with_table(name: str, edit) -> str:
    """A copy of the sources under ``WORK/name`` whose table of instances
    is ``edit(text)``."""
    src = os.path.join(WORK, name)
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(CSRC_DIR, src)
    table = os.path.join(src, "forward_tiles.cuh")
    with open(table) as f:
        text = f.read()
    with open(table, "w") as f:
        f.write(edit(text))
    return src


def build_choice(width: int, row: tuple) -> tuple[str, subprocess.Popen]:
    """Starts nvcc on a copy whose table holds one row and nothing else:
    CHUNKED(width, *row), or where row's ping-pong is None STREAMED(width,
    keys, cols), which as the table's last takes every width."""
    keys, cols, pp = row
    if pp is None:  # one build a streamed row, timed at every width
        line = f"STREAMED({width}, {keys}, {cols})\n"
        return nvcc(copy_with_table(f"streamed_{keys}_{cols}",
                                    lambda text: line))
    line = f"CHUNKED({width}, {keys}, {cols}, {pp})\n"
    return nvcc(copy_with_table(f"chunk_{width}_{keys}_{cols}_{pp}",
                                lambda text: line))


def build(pingpong: int) -> tuple[str, subprocess.Popen]:
    """Starts nvcc on a copy whose one-pass rows all ask for
    ``pingpong``."""
    return nvcc(copy_with_table(
        f"pingpong{pingpong}",
        lambda text: re.sub(r"^TILED\((\d+), (\d+), [01]\)$",
                            rf"TILED(\1, \2, {pingpong})", text,
                            flags=re.M)))


def fwd_report(report: str, instance: str | None = None) -> str:
    """ptxas's registers and spills of the one wgmma forward instance in
    a build's report (the table holds one row), or of the f32 instance
    whose mangled template arguments are ``instance``
    (``16fwd_split_kernelILi32ELi64E...``)."""
    lines = report.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and (
                (instance in line) if instance else (
                "10fwd_kernelI" in line or "17fwd_stream_kernelI" in line)):
            regs = spill = ""
            for later in lines[i + 1:i + 6]:
                if "spill" in later:
                    spill = later.strip()
                elif "registers" in later:
                    regs = later.split(":", 1)[1].strip().split(",")[0]
            return f"{regs}; {spill}"
    return "not found"


def launcher(lib: ctypes.CDLL):
    """``flash_fwd`` of ``lib`` on bf16 or f32 views that TMA reads in
    place."""
    lib.flash_fwd.restype = ctypes.c_int
    lib.flash_fwd_scratch_floats.restype = ctypes.c_longlong
    lib.flash_fwd_scratch_floats.argtypes = [ctypes.c_int] * 4

    def run(q, k, v, scale):
        q, k, v = readable(q, k, v)
        B, H, T, D = q.shape
        out = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
        floats = (lib.flash_fwd_scratch_floats(B, H, T, D)
                  if q.dtype == torch.float32 else 0)
        scratch = torch.empty(max(floats, 1), device=q.device)
        strides = (ctypes.c_longlong * 9)(
            *tma_strides(q), *tma_strides(k), *tma_strides(v))
        err = lib.flash_fwd(
            *(ctypes.c_void_p(t.data_ptr()) for t in (q, k, v, out)),
            ctypes.c_void_p(None), ctypes.c_void_p(scratch.data_ptr()),
            strides,
            *(ctypes.c_int(n) for n in (B, H, T, D)), ctypes.c_float(scale),
            ctypes.c_int(1 if q.dtype == torch.bfloat16 else 0),
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


def model_views(shape, gen, dtype=torch.bfloat16):
    B, H, T, D = shape
    return [torch.randn((B, T, H * D), generator=gen, device="cuda")
            .to(dtype).view(B, T, H, D).transpose(1, 2)
            for _ in range(3)]


def device_ms(fn, n: int = 20) -> float:
    """Device ms a call of ``fn`` over ``n`` calls, by torch.profiler (a
    window that records no kernel of the card is run again, up to 3
    times)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        total = sum(a.self_device_time_total for a in prof.key_averages()
                    if a.self_cpu_time_total == 0)
        if total > 0:
            return total / 1e3 / n
    raise AssertionError("the profiler recorded no kernel of the card")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("forward_choices: needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card)
    only = sys.argv[sys.argv.index("--only") + 1] if "--only" in sys.argv \
        else None
    os.makedirs(WORK, exist_ok=True)
    if only == "f32s":
        f32s = f32s_choices()
        f32s_jobs = [build_f32s(row) for row, _ in f32s]
        try:
            print(json.dumps({"card": card,
                              **measure_f32s(card, f32s, f32s_jobs)}))
        finally:  # no compiler left running
            for _, proc in f32s_jobs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        return
    f32 = f32_choices() if only != "bf16" else []
    f32_jobs = [build_f32(width, row) for width, row, _ in f32]
    choices, jobs = [], []
    if only != "f32":
        choices = chunk_choices()
        builds = {}  # one build a table: a streamed row's serves every width
        for width, row, _ in choices:
            key = row if row[2] is None else (width, row)
            if key not in builds:
                builds[key] = build_choice(width, row)
        jobs = ([builds[row if row[2] is None else (width, row)]
                 for width, row, _ in choices] + [build(pp) for pp in (1, 0)])
    try:
        result = {"card": card}
        if only != "f32":
            result.update(measure(card, choices, jobs))
        if only != "bf16":
            result.update(measure_f32(card, f32, f32_jobs))
        print(json.dumps(result))
    finally:  # no compiler left running
        for _, proc in jobs + f32_jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def measure_f32(card: str, choices, jobs) -> dict:
    """Checks and times each f32 choice against the repo's build, then the
    whole head against the tiled items at each width's last whole-head
    T."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    result = {"f32": [], "f32_whole": {}}
    repo = launcher(library("flash_fwd"))
    for (width, (keys, cols, bf16x3), what), (path, proc) in zip(choices,
                                                                 jobs):
        report, _ = proc.communicate()
        shape = F32_SHAPES[width]
        if proc.returncode != 0:
            first = next((line for line in report.splitlines()
                          if "error" in line), report[-400:])
            print(f"flash_fwd {shape} f32: {what} does not build: "
                  f"{first.strip()}", flush=True)
            result["f32"].append({"width": width, "choice": what,
                                  "built": False})
            continue
        if "wgmma.mma_async instructions are serialized" in report:
            print(f"flash_fwd {shape} f32: {what}: ptxas serialised its "
                  "wgmmas; not timed", flush=True)
            continue
        lib = launcher(ctypes.CDLL(path))
        q, k, v = model_views(shape, gen, torch.float32)
        scale = 1.0 / (shape[1] * shape[3]) ** 0.5
        got, want = lib(q, k, v, scale), repo(q, k, v, scale)
        diff = ((got - want).abs().max().item()
                / (want.abs().max().item() * 1e-5))
        if diff > 2:
            raise AssertionError(f"{shape} {what}: {diff:.2f} units of 1e-5 "
                                 "from the repo's build")
        t_repo, t_choice = in_turns(lambda: repo(q, k, v, scale),
                                    lambda: lib(q, k, v, scale))
        med = statistics.median(t_choice) / statistics.median(t_repo)
        mangled = (f"16fwd_split_kernelILi{width}ELi{keys}ELi{cols}ELb"
                   f"{int(bf16x3)}ELb0E")
        row = {"width": width, "choice": what, "built": True,
               "row": [keys, cols, int(bf16x3)],
               "ptxas": fwd_report(report, mangled), "repo_ms": t_repo,
               "choice_ms": t_choice, "choice_over_repo": med, "diff": diff}
        result["f32"].append(row)
        print(f"flash_fwd {shape} f32: {what} (keys {keys}, {cols} columns, "
              f"bf16x3 {int(bf16x3)}; ptxas {row['ptxas']}) "
              f"{statistics.median(t_choice):.4f} ms against the repo's "
              f"{statistics.median(t_repo):.4f} ms: {med:.3f} (medians of "
              f"{2 * ROUNDS} windows of {ITERS}); {diff:.2f} units of 1e-5 "
              f"from the repo's ({card})", flush=True)
        del q, k, v
    for width, keys in WHOLE_F32_KEYS.items():
        T = max(keys)
        shape = (128, 12, T, width)
        q, k, v = model_views(shape, gen, torch.float32)
        scale = 1.0 / (shape[1] * shape[3]) ** 0.5
        times = {"whole": [], "tiled": []}
        fns = {"whole": lambda: fused_attention(q, k, v, scale),
               "tiled": lambda: flash_attention(q, k, v, scale)}
        for _ in range(ROUNDS):
            for name in ("whole", "tiled", "tiled", "whole"):
                times[name].append(device_ms(fns[name]))
        med = {n: statistics.median(t) for n, t in times.items()}
        result["f32_whole"][str(shape)] = times
        print(f"{shape} f32, the repo's build: mhsa_fwd's whole head "
              f"{med['whole']:.4f} device ms, flash_fwd's tiled items "
              f"{med['tiled']:.4f}: tiled/whole {med['tiled'] / med['whole']:.3f}"
              f" (medians of {2 * ROUNDS} profiled windows of 20, in turns; "
              f"{card})", flush=True)
        del q, k, v
    return result


def kernel_device_ms(fn, n: int = 10) -> dict:
    """Device ms a call of ``fn`` by kernel name (torch.profiler), over
    ``n`` calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {}
    for a in prof.key_averages():
        if a.self_device_time_total > 0:
            name = re.sub(r"\(.*", "", a.key.replace(
                "(anonymous namespace)::", ""))[:90]
            out[name] = out.get(name, 0.0) + a.self_device_time_total / 1e3 / n
    return out


def measure_f32s(card: str, choices, jobs) -> dict:
    """Checks and times each choice of the f32 streamed row against the
    repo's build at every shape of ``F32S_SHAPES``, then the repo's
    build's device ms by kernel there."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    result = {"row": list(F32_FWD_STREAMED), "f32s": [], "kernels": {}}
    repo = launcher(library("flash_fwd"))
    views = {}
    for shape in F32S_SHAPES:
        views[shape] = model_views(shape, gen, torch.float32)
    for (row, what), (path, proc) in zip(choices, jobs):
        report, _ = proc.communicate()
        if proc.returncode != 0:
            first = next((line for line in report.splitlines()
                          if "error" in line), report[-400:])
            print(f"f32 streamed {row}: {what} does not build: "
                  f"{first.strip()}", flush=True)
            result["f32s"].append({"row": list(row), "choice": what,
                                   "built": False})
            continue
        mangled = "23fwd_split_stream_kernelILi{}ELi{}E".format(*row)
        ptxas = fwd_report(report, mangled)
        if "wgmma.mma_async instructions are serialized" in report:
            print(f"f32 streamed {row}: {what}: ptxas serialised its "
                  f"wgmmas; not timed ({ptxas})", flush=True)
            result["f32s"].append({"row": list(row), "choice": what,
                                   "built": True, "serialised": True,
                                   "ptxas": ptxas})
            continue
        if not re.search(r"\b0 bytes spill stores", ptxas):
            # not a candidate (the table's rows do not spill), and one whose
            # wgmma accumulators spill may not run right: not run
            print(f"f32 streamed {row}: {what}: ptxas {ptxas}; spills, not "
                  "timed", flush=True)
            result["f32s"].append({"row": list(row), "choice": what,
                                   "built": True, "spills": True,
                                   "ptxas": ptxas})
            continue
        lib = launcher(ctypes.CDLL(path))
        for shape in F32S_SHAPES:
            q, k, v = views[shape]
            scale = 1.0 / (shape[1] * shape[3]) ** 0.5
            got, want = lib(q, k, v, scale), repo(q, k, v, scale)
            diff = ((got - want).abs().max().item()
                    / (want.abs().max().item() * 1e-5))
            del got, want
            if diff > 2:  # reported, not timed
                print(f"flash_fwd {shape} f32 streamed: {what} {row} "
                      f"DIFFERS from the repo's build by {diff:.2f} units "
                      "of 1e-5", flush=True)
                result["f32s"].append({"row": list(row), "choice": what,
                                       "built": True, "shape": shape,
                                       "diff": diff})
                continue
            t_repo, t_choice = in_turns(lambda: repo(q, k, v, scale),
                                        lambda: lib(q, k, v, scale))
            med = statistics.median(t_choice) / statistics.median(t_repo)
            result["f32s"].append({
                "row": list(row), "choice": what, "built": True,
                "shape": shape, "ptxas": ptxas, "repo_ms": t_repo,
                "choice_ms": t_choice, "choice_over_repo": med,
                "diff": diff})
            print(f"flash_fwd {shape} f32 streamed: {what} {row} (ptxas "
                  f"{ptxas}) {statistics.median(t_choice):.4f} ms against "
                  f"the repo's {statistics.median(t_repo):.4f} ms: {med:.3f} "
                  f"(medians of {2 * ROUNDS} windows of {ITERS}); "
                  f"{diff:.2f} units of 1e-5 from the repo's ({card})",
                  flush=True)
    for shape in F32S_SHAPES:
        q, k, v = views[shape]
        scale = 1.0 / (shape[1] * shape[3]) ** 0.5
        by_kernel = kernel_device_ms(lambda: repo(q, k, v, scale))
        result["kernels"][str(shape)] = by_kernel
        print(f"flash_fwd {shape} f32, the repo's build, device ms a call "
              "by kernel: " + "; ".join(f"{n} {t:.4f}"
                                        for n, t in by_kernel.items())
              + f" ({card})", flush=True)
    return result


def measure(card: str, choices, jobs) -> dict:
    """Checks and times each built choice against the repo's build, then
    the ping-pong builds against each other, then T=1025 against 1024."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    result = {"chunks": [], "pingpong": {}, "ragged": {}}
    repo = launcher(library("flash_fwd"))
    reports = {}  # a shared build's report, read once
    for (width, (keys, cols, pp), what), (path, proc) in zip(choices, jobs):
        if path not in reports:
            reports[path] = proc.communicate()[0]
        report = reports[path]
        shape = (128, 8, 512, width)
        if proc.returncode != 0:
            first = next((line for line in report.splitlines()
                          if "error" in line), report[-400:])
            print(f"flash_fwd {shape} bf16: {what} does not build: "
                  f"{first.strip()}", flush=True)
            result["chunks"].append({"width": width, "choice": what,
                                     "built": False})
            continue
        if "wgmma.mma_async instructions are serialized" in report:
            print(f"flash_fwd {shape} bf16: {what}: ptxas serialised its "
                  "wgmmas; not timed", flush=True)
            continue
        lib = launcher(ctypes.CDLL(path))
        q, k, v = model_views(shape, gen)
        scale = 1.0 / (shape[1] * shape[3]) ** 0.5
        got, want = lib(q, k, v, scale).float(), repo(q, k, v, scale).float()
        diff = ((got - want).abs().max().item()
                / (want.abs().max().item() * 2.0 ** -7))
        if diff > 2:
            raise AssertionError(f"{shape} {what}: {diff:.2f} bf16 steps "
                                 "from the repo's build")
        t_repo, t_choice = in_turns(lambda: repo(q, k, v, scale),
                                    lambda: lib(q, k, v, scale))
        med = statistics.median(t_choice) / statistics.median(t_repo)
        row = {"width": width, "choice": what, "built": True,
               "row": [keys, cols, pp], "ptxas": fwd_report(report),
               "repo_ms": t_repo, "choice_ms": t_choice,
               "choice_over_repo": med, "diff": diff}
        result["chunks"].append(row)
        print(f"flash_fwd {shape} bf16: {what} (keys {keys}, {cols} "
              f"columns, ping-pong {pp}; ptxas {row['ptxas']}) "
              f"{statistics.median(t_choice):.4f} ms against the repo's "
              f"{statistics.median(t_repo):.4f} ms: {med:.3f} (medians of "
              f"{2 * ROUNDS} windows of {ITERS}); {diff:.2f} bf16 steps "
              f"from the repo's ({card})", flush=True)
        del q, k, v
    libs = []
    for path, proc in jobs[len(choices):]:
        report, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed:\n{report}")
        if "wgmma.mma_async instructions are serialized" in report:
            raise SystemExit(f"ptxas serialised wgmmas:\n{report}")
        libs.append(launcher(ctypes.CDLL(path)))
    on, off = libs
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
    return result


if __name__ == "__main__":
    main()
