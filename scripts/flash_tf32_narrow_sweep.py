#!/usr/bin/env python3
"""The f32 split-TF32 K1, dQ and dK/dV at head dim <= 128: which tile plan.

Run from the root of a checkout on a machine with one NVIDIA GPU (nvcc
on the PATH or under $CUDA_HOME):

    python3 scripts/flash_tf32_narrow_sweep.py [variant ...]

Builds ``csrc/flash_attention_fwd.cu`` and ``csrc/flash_attention_bwd.cu``
once per variant (all builds started together, into
``build/narrow_sweep/``), each a copy of the source with its own plans
for ``flash_fwd_tf32x3_narrow_kernel``,
``flash_bwd_dq_tf32x3_narrow_kernel`` and
``flash_bwd_dkv_tf32x3_narrow_kernel`` at padded D 64 and 128 (the
``using NarrowFwd64 = ...`` and ``using NarrowDq64 = ...`` lines: keys or
queries a stage, 8-row n-tiles a sub-step), and prints for each:

1. what ``-Xptxas -v`` says of the narrow kernels (registers, spills,
   shared memory);
2. K1 against ``mha_reference_lse`` (O at the f32 bar 1e-4, the lse at
   1e-3) and dQ and dK/dV against ``flash_attention_bwd_reference`` (the
   f32 bar 1e-4) at B2 H3 T200 (a ragged tile) D 64, 80 and 128, causal
   and not, and at B1 H2 T2048 D 80 and 128 causal (the longest sums)
   (max abs errors, and whether a second launch repeats bit for bit);
3. device ms a call of each (CUDA events over 10 launches after 2) at
   B8 H8 T2048 D64 causal (the attention layer's path), B1 H8 T2048 D64
   causal and B1 H8 T1024 D128 causal, beside SDPA's forward and its
   whole backward.

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

# each kernel's source, by the name its plans carry
SOURCES = {"Fwd": "flash_attention_fwd", "Dq": "flash_attention_bwd",
           "Dkv": "flash_attention_bwd"}
# variant -> the plans it changes (K1, dQ and dK/dV at DP 64 and 128: the
# template arguments after DP); a missing one keeps the source's
VARIANTS = {
    "default": {},
    "stage32": {"Dq64": "32, 4", "Dkv64": "32, 4", "Dq128": "16, 2"},
    "nb8": {"Dq64": "64, 8", "Dkv64": "64, 8"},
    "dkv128_bq32": {"Dkv128": "32, 4"},
}
PLAN = re.compile(r"using Narrow(Fwd|Dq|Dkv)(64|128) = "
                  r"Tf32Narrow(?:Fwd|Dq|Dkv)Cfg<(?:64|128), [^>]*>;")
SHAPES = [(8, 8, 2048, 64), (1, 8, 2048, 64), (1, 8, 1024, 128)]
# the f32 bars: K1's O and lse, the backward's dQ, dK and dV
BARS = {"fwd_o": 1e-4, "fwd_lse": 1e-3, "bwd": 1e-4}


def card():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    return out or torch.cuda.get_device_name(0)


def build(names):
    """Each variant's edited copies of the sources, built by ``_build``
    into ``build/narrow_sweep/``: name → ({source: library}, the ptxas
    lines of both)."""
    out_dir = ROOT / "build" / "narrow_sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    texts = {src: (_build.SRC_DIR / f"{src}.cu").read_text()
             for src in set(SOURCES.values())}
    for src, text in texts.items():
        want = sum(v == src for v in SOURCES.values()) * 2
        if len(PLAN.findall(text)) != want:
            raise SystemExit(f"{src}.cu: the {want} narrow plans not found")
    jobs = {}
    for name in {"default", *names}:
        plans = VARIANTS[name]

        def plan(m):
            kind, dp = m[1], m[2]
            args = plans.get(kind + dp)
            return m[0] if args is None else (
                f"using Narrow{kind}{dp} = Tf32Narrow{kind}Cfg<{dp}, "
                f"{args}>;")
        for src, text in texts.items():
            # a source whose plans the variant keeps is served by the
            # default build
            if name != "default" and not any(
                    SOURCES[key.rstrip("0123456789")] == src
                    for key in plans):
                continue
            copy = out_dir / f"{src}-{name}.cu"
            copy.write_text(PLAN.sub(plan, text))
            jobs[(name, src)] = (src, copy, out_dir / f"{src}-{name}.so")
    logs = _build.compile_sources(jobs, verbose=True)
    return {name: ({src: jobs.get((name, src), jobs[("default", src)])[2]
                    for src in texts},
                   [line for src in sorted(texts) if (name, src) in jobs
                    for line in ptxas_lines(logs[(name, src)])])
            for name in names}


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
    """The largest errors of K1's O and lse and of dQ, dK and dV over the
    cases, and whether every second launch repeated the first."""
    worst = {"fwd_o": 0.0, "fwd_lse": 0.0, "bwd": 0.0}
    repeats = True
    cases = [(2, 3, 200, d, c) for d in (64, 80, 128) for c in (True, False)]
    for b, h, t, d, causal in cases + [(1, 2, 2048, 80, True),
                                       (1, 2, 2048, 128, True)]:
        q, k, v, do, lse, delta = inputs(gen, b, h, t, d, causal)
        s = d ** -0.5
        ref_o, ref_lse = fa.mha_reference_lse(q, k, v, causal=causal)
        fwd = [fa.flash_attention_lse(q, k, v, causal=causal)
               for _ in range(2)]
        ref = fa.flash_attention_bwd_reference(q, k, v, do, lse, delta, s,
                                               causal)
        runs = [(fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, s,
                                           causal),
                 *fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, s,
                                             causal)) for _ in range(2)]
        torch.cuda.synchronize()
        worst["fwd_o"] = max(worst["fwd_o"],
                             (fwd[0][0] - ref_o).abs().max().item())
        worst["fwd_lse"] = max(worst["fwd_lse"],
                               (fwd[0][1] - ref_lse).abs().max().item())
        worst["bwd"] = max(worst["bwd"], *((g - r).abs().max().item()
                                           for g, r in zip(runs[0], ref)))
        repeats &= all(torch.equal(x, y) for x, y in zip(*fwd))
        repeats &= all(torch.equal(x, y) for x, y in zip(*runs))
    return worst, repeats


def times(gen):
    out = {}
    for b, h, t, d in SHAPES:
        q, k, v, do, lse, delta = inputs(gen, b, h, t, d, True)
        s = d ** -0.5
        fwd = events_ms(lambda: fa.flash_attention_lse(q, k, v, causal=True))
        dq = events_ms(lambda: fa.flash_attention_bwd_dq(q, k, v, do, lse,
                                                         delta, s, True))
        dkv = events_ms(lambda: fa.flash_attention_bwd_dkv(q, k, v, do, lse,
                                                           delta, s, True))
        out[f"B{b} H{h} T{t} D{d}"] = {"fwd_ms": fwd, "dq_ms": dq,
                                       "dkv_ms": dkv, "bwd_ms": dq + dkv}
        del q, k, v, do, lse, delta
        torch.cuda.empty_cache()
    return out


def sdpa_times(gen):
    """SDPA's forward and whole backward at each shape, f32 causal."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {}
    for b, h, t, d in SHAPES:
        q, k, v, do = (torch.randn((b, h, t, d), generator=gen,
                                   device="cuda") for _ in range(4))
        q, k, v = (x.requires_grad_(True) for x in (q, k, v))
        with torch.no_grad():
            fwd = events_ms(lambda: sdpa(q, k, v, is_causal=True))
        o = sdpa(q, k, v, is_causal=True)
        out[f"B{b} H{h} T{t} D{d}"] = {
            "fwd_ms": fwd, "bwd_ms": events_ms(lambda: torch.autograd.grad(
                o, (q, k, v), do, retain_graph=True))}
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
        built, ptxas = libs[name]
        for src, lib in built.items():
            _build.use(src, lib)
        err, repeats = check(gen)
        rows[name] = {"plan": VARIANTS[name], "ptxas": ptxas,
                      "max_abs_err": err, "bars": BARS,
                      "repeats": repeats, "times": times(gen)}
        print(json.dumps({name: rows[name]}), flush=True)
    print(json.dumps({"card": card(), "sdpa_ms": sdpa_times(gen),
                      "variants": rows}))
    return 0 if all(r["repeats"] and all(
        r["max_abs_err"][k] <= BARS[k] for k in BARS)
        for r in rows.values()) else 1


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
