#!/usr/bin/env python3
"""The f32 split-TF32 dQ and dK/dV at head dim <= 128: which tile plan.

Run from the root of a checkout on a machine with one NVIDIA GPU (nvcc
on the PATH or under $CUDA_HOME):

    python3 scripts/flash_tf32_narrow_sweep.py [variant ...]

Builds ``csrc/flash_attention_bwd.cu`` once per variant (all builds
started together, into ``build/narrow_sweep/``), each a copy of the
source with its own plan for ``flash_bwd_dq_tf32x3_narrow_kernel`` and
``flash_bwd_dkv_tf32x3_narrow_kernel`` at padded D 64 and 128 (the
``using NarrowDq64 = ...`` lines: keys or queries a stage, 8-row n-tiles
a sub-step), and prints for each:

1. what ``-Xptxas -v`` says of the narrow kernels (registers, spills,
   shared memory);
2. dQ and dK/dV against ``flash_attention_bwd_reference`` at B2 H3 T200
   (a ragged tile) D 64, 80 and 128, causal and not, and at B1 H2 T2048
   D 80 and 128 causal (the longest sums) (max abs error, the f32 bar
   1e-4, and whether a second launch repeats bit for bit);
3. device ms a call of each (CUDA events over 10 launches after 2) at
   B8 H8 T2048 D64 causal (the attention layer's path), B1 H8 T2048 D64
   causal and B1 H8 T1024 D128 causal, beside SDPA's whole backward.

The card's name and power limit come first; one JSON line per variant,
then one line with every variant. ``default`` is the plan the source
ships; no argument runs every variant below.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from deeplearning4j_tpu_torch.kernels import _build  # noqa: E402
from deeplearning4j_tpu_torch.kernels import (  # noqa: E402
    flash_attention as fa)

NAME = "flash_attention_bwd"
# variant -> the plans it changes (DP 64 dQ, DP 128 dQ, DP 64 dK/dV, DP 128
# dK/dV: the template arguments after DP); a missing one keeps the
# source's
VARIANTS = {
    "default": {},
    "stage32": {"Dq64": "32, 4", "Dkv64": "32, 4", "Dq128": "16, 2"},
    "nb8": {"Dq64": "64, 8", "Dkv64": "64, 8"},
    "dkv128_bq32": {"Dkv128": "32, 4"},
}
PLAN = re.compile(r"using Narrow(Dq|Dkv)(64|128) = Tf32Narrow(?:Dq|Dkv)Cfg"
                  r"<(?:64|128), [^>]*>;")
SHAPES = [(8, 8, 2048, 64), (1, 8, 2048, 64), (1, 8, 1024, 128)]


def card():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    return out or torch.cuda.get_device_name(0)


def build(names):
    """Each variant's edited copy of the source, built by ``_build`` into
    ``build/narrow_sweep/``: name → (library, its ptxas lines)."""
    out_dir = ROOT / "build" / "narrow_sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    text = (_build.SRC_DIR / f"{NAME}.cu").read_text()
    if len(PLAN.findall(text)) != 4:
        raise SystemExit(f"{NAME}.cu: the four narrow plans not found")
    jobs = {}
    for name in names:
        plans = VARIANTS[name]

        def plan(m):
            kind, dp = m[1], m[2]
            args = plans.get(kind + dp)
            return m[0] if args is None else (
                f"using Narrow{kind}{dp} = Tf32Narrow{kind}Cfg<{dp}, "
                f"{args}>;")
        src = out_dir / f"{NAME}-{name}.cu"
        src.write_text(PLAN.sub(plan, text))
        jobs[name] = (NAME, src, out_dir / f"{NAME}-{name}.so")
    logs = _build.compile_sources(jobs, verbose=True)
    return {name: (jobs[name][2], ptxas_lines(logs[name])) for name in names}


def ptxas_lines(log):
    """The -Xptxas -v lines of the narrow kernels: the function's name,
    then its registers, spills and shared memory."""
    keep, lines = False, []
    for line in log.splitlines():
        if "Compiling entry function" in line or "Function properties" in line:
            keep = "narrow" in line
        if keep and ("narrow" in line or "registers" in line
                     or "spill" in line):
            lines.append(line.split("ptxas info    :")[-1].strip())
    return lines


def events_ms(fn, iters=10, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def inputs(gen, b, h, t, d, causal):
    q, k, v, do = (torch.randn((b, h, t, d), generator=gen, device="cuda")
                   for _ in range(4))
    o, lse = fa.mha_reference_lse(q, k, v, causal=causal)
    delta = (do * o).sum(-1).contiguous()
    return q, k, v, do, lse, delta


def check(gen):
    worst, repeats = 0.0, True
    cases = [(2, 3, 200, d, c) for d in (64, 80, 128) for c in (True, False)]
    for b, h, t, d, causal in cases + [(1, 2, 2048, 80, True),
                                       (1, 2, 2048, 128, True)]:
        q, k, v, do, lse, delta = inputs(gen, b, h, t, d, causal)
        s = d ** -0.5
        ref = fa.flash_attention_bwd_reference(q, k, v, do, lse, delta, s,
                                               causal)
        runs = [(fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, s,
                                           causal),
                 *fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, s,
                                             causal)) for _ in range(2)]
        torch.cuda.synchronize()
        worst = max(worst, *((g - r).abs().max().item()
                             for g, r in zip(runs[0], ref)))
        repeats &= all(torch.equal(x, y) for x, y in zip(*runs))
    return worst, repeats


def times(gen):
    out = {}
    for b, h, t, d in SHAPES:
        q, k, v, do, lse, delta = inputs(gen, b, h, t, d, True)
        s = d ** -0.5
        dq = events_ms(lambda: fa.flash_attention_bwd_dq(q, k, v, do, lse,
                                                         delta, s, True))
        dkv = events_ms(lambda: fa.flash_attention_bwd_dkv(q, k, v, do, lse,
                                                           delta, s, True))
        out[f"B{b} H{h} T{t} D{d}"] = {"dq_ms": dq, "dkv_ms": dkv,
                                       "sum_ms": dq + dkv}
        del q, k, v, do, lse, delta
        torch.cuda.empty_cache()
    return out


def sdpa_times(gen):
    out = {}
    for b, h, t, d in SHAPES:
        q, k, v, do = (torch.randn((b, h, t, d), generator=gen,
                                   device="cuda") for _ in range(4))
        q, k, v = (x.requires_grad_(True) for x in (q, k, v))
        o = torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=True)
        out[f"B{b} H{h} T{t} D{d}"] = events_ms(lambda: torch.autograd.grad(
            o, (q, k, v), do, retain_graph=True))
    return out


def main(argv):
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    names = argv or list(VARIANTS)
    print(card(), flush=True)
    libs = build(names)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {}
    for name in names:
        lib, ptxas = libs[name]
        _build.use(NAME, lib)
        err, repeats = check(gen)
        rows[name] = {"plan": VARIANTS[name], "ptxas": ptxas,
                      "max_abs_err": err, "f32_bar": 1e-4,
                      "repeats": repeats, "times": times(gen)}
        print(json.dumps({name: rows[name]}), flush=True)
    print(json.dumps({"card": card(), "sdpa_backward_ms": sdpa_times(gen),
                      "variants": rows}))
    return 0 if all(r["max_abs_err"] <= 1e-4 and r["repeats"]
                    for r in rows.values()) else 1


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
