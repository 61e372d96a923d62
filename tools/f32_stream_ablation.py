"""Where the streamed f32 backward pair's time goes, by ablation, on one
CUDA card.

    python3 tools/f32_stream_ablation.py [--shape 128,8,512,256] [--rounds 3]

Writes copies of this checkout's ``vit_cifar_torch`` under
``build/ablation/<variant>/``, each with one part of
``dq_split_stream_kernel`` (``csrc/flash_bwd_dq.cu``) and
``dkv_split_stream_kernel`` (``csrc/flash_bwd_dkv.cu``) taken out, builds
them all at once (one ``nvcc`` a source), and times the dq and the dk/dv
pass of every copy in turns, each copy in a fresh process, on f32 (B, H, T,
D) views of (B, T, H, D) tensors as the model passes them (CUDA events; the
median of ``--rounds`` windows of about 50 ms).  The variants:

- ``full``: the kernels as the package has them;
- ``no_convert``: the converter warps do not split the ring's 32-column
  chunks (the consumers read the raw chunk as big and stale bytes as small);
- ``one_product``: s and dp (s^T and dp^T) one TF32 product a k8 step,
  big.big, where the kernels run three;
- ``no_logits``: no products of s and dp at all (the ring's stages still
  waited for, committed, waited on and released);
- ``no_grads``: no gradient products (dq's ds.k; dk/dv's ds^T.q, p^T.do).

Every copy but ``full`` computes wrong gradients: they are timed only.  For
each pass the tool also prints what the kernels' products do at the shape,
counted from the table's row (``f32_backward_plan``): the wgmma
instructions of s and dp and of the gradients, the bytes they read from
shared memory (an ss wgmma reads A and B there, an rs wgmma B) and their
tensor FLOPs; and, over the time that ``no_logits`` saves, the rate at
which s and dp's wgmmas read shared memory, a clock an SM, at the card's
``clocks.max.sm`` and its SM count.  One JSON line a variant, then one of
the counts, after the card's name, power limit and top SM clock.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "build", "ablation")
KERNELS = {"flash_bwd_dq.cu": "dq_split_stream_kernel(",
           "flash_bwd_dkv.cu": "dkv_split_stream_kernel("}
# what a variant puts in front of the kernel, and what it replaces in it
HELPERS = """
// ablation helpers (tools/f32_stream_ablation.py)
template <int kDp, int kN, bool = false>
__device__ __forceinline__ void product_ss_one(float (&d)[kN / 2], uint32_t a,
                                               uint32_t, int a_rows,
                                               uint32_t b, uint32_t) {
  using namespace attn_wg;
  using A = F32Atoms<kDp>;
#pragma unroll
  for (int kk = 0; kk < kDp / 8; ++kk)
    Tf32<kN>::ss(d,
                 make_desc(a + kk / 4 * a_rows * A::kRowBytes + 32 * (kk % 4),
                           16, A::kSbo, 1),
                 make_desc(b + kk / 4 * kN * A::kRowBytes + 32 * (kk % 4), 16,
                           A::kSbo, 1),
                 kk);
}
template <int kDp, int kN, bool = false>
__device__ __forceinline__ void product_ss_none(float (&d)[kN / 2], uint32_t,
                                                uint32_t, int, uint32_t,
                                                uint32_t) {
#pragma unroll
  for (int x = 0; x < kN / 2; ++x) d[x] = 0.f;
}
template <class... Args>
__device__ __forceinline__ void product_none(Args...) {}

"""
SPLIT = "split_tile(stage, stage + S::kRawBytes, S::kRawBytes, cw, lane);"
VARIANTS = {
    "full": {},
    "no_convert": {SPLIT: ""},
    "one_product": {"product_ss_tf32<32, ": "product_ss_one<32, "},
    "no_logits": {"product_ss_tf32<32, ": "product_ss_none<32, "},
    "no_grads": {"ds.template product<kCols, kCols>(": "product_none(",
                 "pf.template product<kCols, kCols>(": "product_none(",
                 "dsf.template product<kCols, kCols>(": "product_none("},
}


def ablate(text: str, anchor: str, patches: dict, used: set) -> str:
    """``text`` with those of ``patches`` that occur in the kernel whose
    definition starts at ``anchor`` applied there (each added to
    ``used``), and the helpers in front of it."""
    start = text.index("template", text.rindex("\n\n", 0, text.index(
        "__global__ void __launch_bounds__(attn_wg::kThreads, 1)\n    "
        + anchor)))
    end = text.index("\n}\n", start) + 3
    body = text[start:end]
    for old, new in patches.items():
        if old in body:
            body = body.replace(old, new)
            used.add(old)
    return text[:start] + HELPERS + body + text[end:]


def make_copies(variants) -> dict:
    """One copy of the package a variant under ``build/ablation/``."""
    copies = {}
    for name in variants:
        dest = os.path.join(OUT, name)
        pkg = os.path.join(dest, "vit_cifar_torch")
        shutil.rmtree(pkg, ignore_errors=True)
        shutil.copytree(os.path.join(ROOT, "vit_cifar_torch"), pkg,
                        ignore=shutil.ignore_patterns("__pycache__"))
        used = set()
        for src, anchor in KERNELS.items():
            path = os.path.join(pkg, "csrc", src)
            with open(path) as f:
                text = f.read()
            text = ablate(text, anchor, VARIANTS[name], used)
            with open(path, "w") as f:
                f.write(text)
        if set(VARIANTS[name]) - used:  # the kernels changed: say so
            raise SystemExit(f"ablation {name}: no kernel holds "
                             f"{sorted(set(VARIANTS[name]) - used)}")
        copies[name] = dest
    return copies


def build_all(copies: dict) -> None:
    """Every copy's two libraries, all the copies at once."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from vit_cifar_torch.ops.cuda.build import build_libraries; "
            "build_libraries(['flash_bwd_dq', 'flash_bwd_dkv'])")
    procs = {name: subprocess.Popen([sys.executable, "-c", code, dest],
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
             for name, dest in copies.items()}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"ablation {name}: build failed\n{out[-6000:]}")


def worker(dest: str, shape, rounds: int) -> None:
    sys.path.insert(0, dest)
    import torch

    import vit_cifar_torch
    from vit_cifar_torch.ops.cuda.flash_attention import (
        flash_attention_lse, flash_tiled_bwd_dkv, flash_tiled_bwd_dq)

    if not os.path.abspath(vit_cifar_torch.__file__).startswith(dest):
        raise SystemExit(f"imported vit_cifar_torch from "
                         f"{vit_cifar_torch.__file__}")
    B, H, T, D = shape
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = (torch.randn(B, T, H, D, generator=gen, device="cuda")
                   for _ in range(4))
    q, k, v = (a.transpose(1, 2) for a in (q, k, v))
    scale = D ** -0.5
    o, lse = flash_attention_lse(q, k, v, scale)
    calls = {"dq": lambda: flash_tiled_bwd_dq(q, k, v, o, do, lse, scale),
             "dkv": lambda: flash_tiled_bwd_dkv(q, k, v, o, do, lse, scale)}
    out = {}
    for name, call in calls.items():
        call()
        torch.cuda.synchronize()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        call()
        b.record()
        torch.cuda.synchronize()
        n = max(1, int(50 / max(a.elapsed_time(b), 1e-3)))
        times = []
        for _ in range(rounds):
            a.record()
            for _ in range(n):
                call()
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b) / n)
        out[name] = statistics.median(times)
    print(json.dumps(out))


def counts(shape) -> dict:
    """The wgmmas of each pass at ``shape``, from the table's streamed rows
    (the kernels' loops: every item takes every tile of the other side
    and, per tile, every 32-column chunk of D for s and dp)."""
    sys.path.insert(0, ROOT)
    from vit_cifar_torch.ops.cuda.common import f32_backward_plan

    B, H, T, D = shape
    plan = f32_backward_plan(T, D)
    n_dc = -(-D // 32)
    out = {}
    for kind in ("dq", "dkv"):
        row = plan[kind]
        tile, cols, bf16x3 = row["tile"], row["cols"], row["bf16x3"]
        items = B * H * row["items"]
        tiles = -(-T // tile)
        # s and dp: per item, tile and chunk, each consumer 2 x 4 k8 steps
        # x 3 products of m64 n{tile} k8, A (64 x 8) and B (tile x 8) f32
        ss = items * tiles * n_dc * 2 * 2 * 4 * 3
        ss_bytes = ss * (64 * 8 + tile * 8) * 4
        ss_flops = ss * 2 * 64 * tile * 8
        # gradients: per item and tile, each consumer one (dq) or two
        # (dk, dv) products of m64 n{cols} over the tile: six bf16 k16
        # products a step, or three TF32 k8 ones; rs: B from shared memory
        prods = 1 if kind == "dq" else 2
        if bf16x3:
            rs = items * tiles * 2 * prods * (tile // 16) * 6
            rs_bytes = rs * 16 * cols * 2
            rs_flops = rs * 2 * 64 * cols * 16
        else:
            rs = items * tiles * 2 * prods * (tile // 8) * 3
            rs_bytes = rs * 8 * cols * 4
            rs_flops = rs * 2 * 64 * cols * 8
        out[kind] = {"tile": tile, "cols": cols, "bf16x3": bf16x3,
                     "items": items, "ss_wgmmas": ss, "ss_bytes": ss_bytes,
                     "ss_flops": ss_flops, "rs_wgmmas": rs,
                     "rs_bytes": rs_bytes, "rs_flops": rs_flops}
    return out


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--shape", default="128,8,512,256")
    parser.add_argument("--rounds", type=int, default=3)
    parser.add_argument("--worker")
    args = parser.parse_args()
    shape = tuple(int(x) for x in args.shape.split(","))
    if args.worker:
        worker(args.worker, shape, args.rounds)
        return
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("f32_stream_ablation: "
                         "torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(smi.split(",")[2].split()[0])
    copies = make_copies(VARIANTS)
    build_all(copies)
    times = {name: [] for name in copies}
    for _ in range(2):  # in turns, forward then backward order
        for name in list(copies) + list(copies)[::-1]:
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--shape",
                 args.shape, "--rounds", str(args.rounds), "--worker",
                 copies[name]], capture_output=True, text=True)
            if proc.returncode != 0:
                raise SystemExit(f"ablation {name}:\n{proc.stderr[-4000:]}")
            times[name].append(json.loads(proc.stdout.strip()
                                          .splitlines()[-1]))
    med = {name: {kind: statistics.median(r[kind] for r in runs)
                  for kind in ("dq", "dkv")} for name, runs in times.items()}
    for name, runs in times.items():
        print(json.dumps({"variant": name, "shape": shape, "ms": med[name],
                          "runs": runs}), flush=True)
    count = counts(shape)
    for kind, row in count.items():
        saved = med["full"][kind] - med["no_logits"][kind]
        row["full_ms"] = med["full"][kind]
        row["no_logits_saves_ms"] = saved
        if saved > 0:
            clocks = saved * 1e-3 * mhz * 1e6 * sms
            row["ss_bytes_a_clock_an_sm"] = row["ss_bytes"] / clocks
            row["ss_tensor_share_of_tf32_peak"] = (
                row["ss_flops"] / (saved * 1e-3) / 495e12)
    print(json.dumps({"counts": count, "sms": sms, "clocks_max_sm_mhz": mhz}))


if __name__ == "__main__":
    main()
