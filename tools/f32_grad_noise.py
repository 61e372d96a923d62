"""How far the f32 gradients of a head_dim-192 attention layer sit from an
f64 reference, on one CUDA card, for one or two checkouts of the port.

    python3 tools/f32_grad_noise.py CHECKOUT [CHECKOUT ...] [--draws 20]

For each checkout, in a fresh process that imports its ``vit_cifar_torch``:
``MultiHeadSelfAttention(384, 2)`` at T=257 in f32, as
``tests/test_torch_cuda.py::test_fused_at_head_dim_192_serves_and_trains_on_the_card``
builds it (weights from ``torch.Generator().manual_seed(1)``), on the kernel
routes ``"fused"`` and ``"flash"``, its ``"einsum"`` twin in f32 and the
same einsum module in f64; for each of ``--draws`` inputs x and cotangents g
(B=2, from a CUDA generator seeded with the draw's number) the gradients of
x and of every parameter.  Prints, for each route and tensor, the largest
distance from the f64 gradients of the kernel path and of the f32 einsum
path, and in how many draws the kernel path misses the card tests' f32
gradient limit (rtol 1e-4 / atol 1e-5, ``torch.testing.assert_close``'s
rule) against the f32 einsum path and against the f64 one.

Then the backward pair alone, at that layer's heads, (2, 2, 257, 192): for
each draw q, k, v and do from the same generator (q, k, v as (B, H, T, D)
views of (B, T, H, D) tensors, as the layer passes them), o and lse
computed in f64 and rounded to f32; dq, dk, dv of the kernels
(``flash_tiled_bwd_dq`` and ``flash_tiled_bwd_dkv``) and of their plain
f32 versions, each against the same formulas in f64 on those f32 inputs:
the largest distance and the root mean square one, and the largest
distance of dv summed over keys (what a value bias's gradient sums).
One JSON line a checkout, after the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

RTOL, ATOL = 1e-4, 1e-5


def worker(checkout: str, draws: int) -> None:
    sys.path.insert(0, os.path.abspath(checkout))
    import torch

    import vit_cifar_torch
    from vit_cifar_torch.ops.attention import MultiHeadSelfAttention

    where = os.path.dirname(os.path.abspath(vit_cifar_torch.__file__))
    if not where.startswith(os.path.abspath(checkout)):
        raise SystemExit(f"imported vit_cifar_torch from {where}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def module(route, dtype=torch.float32):
        return MultiHeadSelfAttention(
            384, 2, pallas_kernel=route, device="cuda", dtype=dtype,
            generator=torch.Generator().manual_seed(1))

    ref32 = module("einsum")
    ref64 = module("einsum", torch.float64)
    ref64.load_state_dict({k: v.double()
                           for k, v in ref32.state_dict().items()})
    kernels = {route: module(route) for route in ("fused", "flash")}
    for m in kernels.values():
        m.load_state_dict(ref32.state_dict())
    names = ["x"] + [n for n, _ in ref32.named_parameters()]

    def grads(m, x, g):
        x = x.clone().requires_grad_()
        return torch.autograd.grad(m(x), [x, *m.parameters()], g)

    def misses(a, w):
        return bool(((a.double() - w.double()).abs()
                     > ATOL + RTOL * w.double().abs()).any())

    out = {route: {n: {"kernel_f64": 0.0, "einsum_f64": 0.0,
                       "misses_einsum": 0, "misses_f64": 0}
                   for n in names} for route in kernels}
    for draw in range(draws):
        gen = torch.Generator(device="cuda").manual_seed(draw)
        x = torch.randn(2, 257, 384, generator=gen, device="cuda")
        g = torch.randn(2, 257, 384, generator=gen, device="cuda")
        want32 = grads(ref32, x, g)
        want64 = grads(ref64, x.double(), g.double())
        for route, m in kernels.items():
            for n, a, w32, w64 in zip(names, grads(m, x, g), want32,
                                      want64):
                row = out[route][n]
                row["kernel_f64"] = max(row["kernel_f64"],
                                        (a.double() - w64).abs().max().item())
                row["einsum_f64"] = max(row["einsum_f64"],
                                        (w32.double() - w64).abs().max().item())
                row["misses_einsum"] += misses(a, w32)
                row["misses_f64"] += misses(a, w64)
    torch.cuda.synchronize()
    print(json.dumps({"checkout": checkout, "draws": draws,
                      "device": torch.cuda.get_device_name(0),
                      "routes": out, "pair": pair(draws)}))


def pair(draws: int, shape=(2, 2, 257, 192)) -> dict:
    """The backward pair alone against f64, beside its plain f32 version
    (see the module's docstring)."""
    import torch

    from vit_cifar_torch.ops.cuda.flash_attention import (
        flash_tiled_bwd_dkv, flash_tiled_bwd_dkv_reference,
        flash_tiled_bwd_dq, flash_tiled_bwd_dq_reference)

    B, H, T, D = shape
    scale = D ** -0.5
    keys = ("dq", "dk", "dv", "dv_key_sum")
    out = {who: {n: {"max": 0.0, "rms": 0.0} for n in keys}
           for who in ("kernel", "plain_f32")}
    for draw in range(draws):
        gen = torch.Generator(device="cuda").manual_seed(1000 + draw)
        q, k, v, do = (torch.randn(B, T, H, D, generator=gen, device="cuda")
                       for _ in range(4))
        q, k, v = (a.transpose(1, 2) for a in (q, k, v))  # (B, H, T, D)
        q64, k64, v64 = (a.double() for a in (q, k, v))
        do64 = do.double().transpose(1, 2)
        s = torch.einsum("bhid,bhjd->bhij", q64, k64) * scale
        lse64 = torch.logsumexp(s, dim=-1)
        o = torch.einsum("bhij,bhjd->bhid", torch.exp(s - lse64[..., None]),
                         v64).float()
        lse = lse64.float()
        o_btd = o.transpose(1, 2).contiguous()  # (B, T, H, D)
        # the f64 gradients from the f32 inputs, o and lse among them
        p = torch.exp(s - lse.double()[..., None])
        dp = torch.einsum("bhid,bhjd->bhij", do64, v64)
        delta = (do64 * o.double()).sum(-1, keepdim=True)
        ds = p * (dp - delta) * scale
        want = (torch.einsum("bhij,bhjd->bhid", ds, k64),
                torch.einsum("bhij,bhid->bhjd", ds, q64),
                torch.einsum("bhij,bhid->bhjd", p, do64))
        for who, dq_fn, dkv_fn in (
                ("kernel", flash_tiled_bwd_dq, flash_tiled_bwd_dkv),
                ("plain_f32", flash_tiled_bwd_dq_reference,
                 flash_tiled_bwd_dkv_reference)):
            got = (dq_fn(q, k, v, o_btd, do, lse, scale),
                   *dkv_fn(q, k, v, o_btd, do, lse, scale))
            errs = [g.double() - w for g, w in zip(got, want)]
            errs.append(errs[2].sum(dim=2))
            for n, e in zip(keys, errs):
                row = out[who][n]
                row["max"] = max(row["max"], e.abs().max().item())
                row["rms"] += e.pow(2).mean().item() / draws
    for rows in out.values():
        for row in rows.values():
            row["rms"] = row["rms"] ** 0.5
    return out


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("checkouts", nargs="+")
    parser.add_argument("--draws", type=int, default=20)
    parser.add_argument("--worker", action="store_true")
    args = parser.parse_args()
    if args.worker:
        worker(args.checkouts[0], args.draws)
        return
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("f32_grad_noise: torch.cuda.is_available() is false")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    for checkout in args.checkouts:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__),
             os.path.abspath(checkout), "--worker", "--draws",
             str(args.draws)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise SystemExit(f"{checkout} failed:\n{proc.stderr[-4000:]}")
        print(proc.stdout.strip().splitlines()[-1], flush=True)


if __name__ == "__main__":
    main()
