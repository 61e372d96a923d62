"""The attention route's default rule (``ops/attention.py::route``),
measured on one CUDA card.

    python3 tools/route_choices.py

The default takes the whole-head forward ("fused", ``fused_attention``)
where one of its whole-head instances holds the head as one key tile in
the module's dtype (``whole_head_holds``), the tiled kernels ("flash",
``flash_attention``) elsewhere; both take the same tiled backward pair.
This times the two paths against each other on the model's (B, H, T, D)
views of (B, T, H*D) projections, in bf16 and in f32 (TF32 off for the
library's calls), in turns (fused, flash, flash, fused), as device ms a
call under torch.profiler (the kernels' own time; at small T an event
window follows the host): the inference forward, and the forward with
lse and the backward pair through each path's autograd Function (fwd+bwd,
a (B, T, H, D) cotangent).  Shapes: at each whole-head table's last T at
head_dim 32, 64 and 128 (bf16 128, 96 and 64 keys; f32 72, 64 and 32) and
one key past it, B=128 and 384 features (12, 6 and 3 heads), and the cells
of ``docs/PERFORMANCE.md``: (128, 12, 65, 32), (512, 8, 256, 128), (128,
8, 512, 128), (64, 4, 1024, 128), (16, 2, 2048, 128) and (8, 1, 4096,
128), where SDPA's forward and fwd+bwd are timed beside them as the
library's yardstick.  Prints the card's name and power limit, a line a
shape and dtype, and one JSON object last.
"""

from __future__ import annotations

import importlib.util
import json
import os
import statistics
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from vit_cifar_torch.ops.attention import route  # noqa: E402
from vit_cifar_torch.ops.cuda.attention import (  # noqa: E402
    FusedAttentionFunction, fused_attention)
from vit_cifar_torch.ops.cuda.common import (  # noqa: E402
    WHOLE_F32_KEYS, WHOLE_KEYS)
from vit_cifar_torch.ops.cuda.flash_attention import (  # noqa: E402
    FlashAttentionFunction, flash_attention)

DOC_CELLS = ((128, 12, 65, 32), (512, 8, 256, 128), (128, 8, 512, 128),
             (64, 4, 1024, 128), (16, 2, 2048, 128), (8, 1, 4096, 128))
ROUNDS = 2


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def boundary_shapes(dtype) -> list[tuple]:
    """(B, H, T, D) at each whole-head table's last T and one key past it,
    at each width, B=128 and 384 features."""
    keys = WHOLE_KEYS if dtype == torch.bfloat16 else WHOLE_F32_KEYS
    return [(128, 384 // width, T, width) for width in sorted(keys)
            for T in (max(keys[width]), max(keys[width]) + 1)]


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("route_choices: needs a CUDA card")
    smoke = _smoke()
    card = smoke.card_line()
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    result = {"card": card, "rows": []}
    for dtype in (torch.bfloat16, torch.float32):
        kind = "bf16" if dtype == torch.bfloat16 else "f32"
        for shape in [*boundary_shapes(dtype), *DOC_CELLS]:
            B, H, T, D = shape
            scale = 1.0 / (H * D) ** 0.5
            x = [t.requires_grad_() for t in
                 smoke.model_views(shape, gen, dtype)]
            g = torch.randn((B, T, H, D), generator=gen,
                            device="cuda").to(dtype)

            def train(function):
                out = function.apply(*x, scale)
                return torch.autograd.grad(out, x, g)

            fns = {
                "fused fwd": lambda: fused_attention(
                    *(t.detach() for t in x), scale),
                "flash fwd": lambda: flash_attention(
                    *(t.detach() for t in x), scale),
                "fused fwd+bwd": lambda: train(FusedAttentionFunction),
                "flash fwd+bwd": lambda: train(FlashAttentionFunction)}
            doc = shape in DOC_CELLS
            if doc:
                def sdpa():
                    return torch.nn.functional.scaled_dot_product_attention(
                        *x, scale=scale)

                fns["SDPA fwd"] = lambda: sdpa().detach()
                fns["SDPA fwd+bwd"] = lambda: torch.autograd.grad(
                    sdpa(), x, g.transpose(1, 2))
            times = {name: [] for name in fns}
            for _ in range(ROUNDS):
                for part in ("fwd", "fwd+bwd"):
                    names = [n for n in fns if n.endswith(" " + part)]
                    for name in names + names[::-1]:
                        ms, _ = smoke.device_ms(fns[name])
                        if ms is not None:
                            times[name].append(ms)
            med = {n: statistics.median(t) if t else None
                   for n, t in times.items()}
            row = {"dtype": kind, "shape": shape,
                   "route": route(T, D, None, dtype=dtype),
                   "doc_cell": doc, "device_ms": times}
            result["rows"].append(row)

            def text(name):
                return ("not measured" if med[name] is None
                        else f"{med[name]:.4f}")

            ratio = {part: (med[f"flash {part}"] / med[f"fused {part}"]
                            if med[f"flash {part}"] and med[f"fused {part}"]
                            else float("nan"))
                     for part in ("fwd", "fwd+bwd")}
            line = (f"{kind} {shape} (default route {row['route']}): "
                    f"fused fwd {text('fused fwd')}, flash fwd "
                    f"{text('flash fwd')} (flash/fused {ratio['fwd']:.3f}); "
                    f"fused fwd+bwd {text('fused fwd+bwd')}, flash fwd+bwd "
                    f"{text('flash fwd+bwd')} (flash/fused "
                    f"{ratio['fwd+bwd']:.3f})")
            if doc:
                line += (f"; SDPA fwd {text('SDPA fwd')}, fwd+bwd "
                         f"{text('SDPA fwd+bwd')}")
            print(f"{line} (device ms, medians of {2 * ROUNDS} profiled "
                  f"windows of 20, in turns; {card})", flush=True)
            del x, g, fns
            torch.cuda.empty_cache()
    print(json.dumps(result))


if __name__ == "__main__":
    main()
