#!/usr/bin/env python3
"""Where K4's cluster route spends a step, and which cluster size is best.

Run from the root of a checkout on a machine with one NVIDIA GPU (nvcc
on the PATH or under $CUDA_HOME):

    python3 scripts/k4_cluster_sweep.py [sizes] [breakdown] [short_t]

(all three parts when none is named).

1. Cluster sizes: the cluster kernels of ``csrc/fused_lstm.cu`` at every
   cluster size C that splits H into slices of 8 units (the plan takes
   the largest), beside the block route, at T 60 and B 256/64, H 128,
   256 and 384, bf16 and f32: device ms a call, max abs error against
   ``lstm_seq_reference`` and the clusters the card keeps resident.
2. The bf16 step's parts at B 256 H 256: copies of the source with one
   part of the step taken out (the DSMEM exchange and its wait, the
   product, the cell update, the xproj prefetch, the output store), each
   built by nvcc into ``build/k4_sweep/`` and timed at T 60 and 240;
   (ms at T 240 - ms at T 60) / 180 is the cost of a step, and a
   variant's drop against the whole kernel is the part's share of the
   step's dependent chain. The variants compute wrong results and are
   used for nothing else. Each edit must apply to the source exactly
   once; the script stops at the first that does not.
3. Short sequences: both routes at T 1 to 128, bf16 and f32, B 16 to
   1024, H 256 and 128: the T from which the cluster route wins, and the
   T at which ``lstm_route`` takes the slower route.

Times are device ms a call from CUDA-graph replays of 10 launches (no
host launch cost in them), with the card's name and power limit printed
first. Prints one line per shape and one per T.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from deeplearning4j_tpu_torch.kernels import _build  # noqa: E402
from deeplearning4j_tpu_torch.kernels import fused_lstm as fl  # noqa: E402

# the parts of the bf16 step each variant takes out: (text, replacement)
# pairs applied to csrc/fused_lstm.cu, each of which must apply once
NO_EXCHANGE = [("    ex.wait(t);\n\n    // z += round(h_{t-1})",
                "\n    // z += round(h_{t-1})"),
               ("if (t + 1 < Tn) {\n      ex.expect(t, 32 * H);",
                "if (false) {\n      ex.expect(t, 32 * H);")]
NO_PRODUCT = [("for (int s = 0; s < steps; ++s) {",
               "for (int s = 0; s < 0; ++s) {")]
NO_CELL = [("const float h = cell<true>(zc, c[e], pi[e], pf[e], po[e]);",
            "const float h = zc[0] + zc[1] + zc[2] + zc[3] + c[e];")]
NO_PREFETCH = [("load_x(x2, t + 2);  // in flight for two steps", "")]
NO_STORE = [("    if (row < rows)\n      *reinterpret_cast<uint32_t*>(",
             "    if (false)\n      *reinterpret_cast<uint32_t*>(")]
VARIANTS = {"whole": [], "no_exchange": NO_EXCHANGE,
            "no_product": NO_PRODUCT, "no_cell": NO_CELL,
            "no_prefetch": NO_PREFETCH, "no_store": NO_STORE,
            "exchange_only": NO_PRODUCT + NO_CELL + NO_PREFETCH + NO_STORE}


def graph_ms(call, n=10, reps=5):
    """Device ms of one ``call`` from replays of a graph of ``n``."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            call()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (n * reps)


def inputs(gen, b, t, h, dtype):
    x = torch.randn((b, t, 4 * h), generator=gen, device="cuda").to(dtype)
    rw = (torch.randn((h, 4 * h), generator=gen, device="cuda")
          * h ** -0.5).to(dtype)
    p = torch.randn((3, h), generator=gen, device="cuda") * 0.1
    z = torch.zeros((b, h), device="cuda")
    return x, rw, p, z, z.clone()


def launcher(lib, fn, ins, out, plan):
    x, rw, p, h0, c0 = ins
    b, t, g4 = x.shape

    def call():
        rc = getattr(lib, fn)(
            x.data_ptr(), rw.data_ptr(), p.data_ptr(), h0.data_ptr(),
            c0.data_ptr(), out.data_ptr(), b, t, g4 // 4,
            fl._DTYPES[x.dtype], *plan,
            torch.cuda.current_stream().cuda_stream)
        _build.check(rc, fn)
    return call


def plan_args(plan):
    """A :class:`fused_lstm.ClusterPlan`'s launch arguments."""
    return plan.cluster, plan.k_slices, plan.threads, plan.smem


def sizes(gen):
    lib = fl._load()
    for dtype in (torch.bfloat16, torch.float32):
        for b, t, h in ((256, 60, 256), (64, 60, 256), (256, 60, 128),
                        (256, 60, 384)):
            ins = inputs(gen, b, t, h, dtype)
            ref = fl.lstm_seq_reference(*ins)
            out = torch.empty((b, t, h), dtype=dtype, device="cuda")
            row = {}
            for c in (8, 4, 2, 1):
                plan = fl._cluster_plan_at(b, h, dtype, c)
                if plan is None:
                    continue
                plan = plan_args(plan)
                ms = graph_ms(launcher(lib, "dl4j_lstm_seq_cluster", ins,
                                       out, plan))
                err = (out.float() - ref.float()).abs().max().item()
                active = lib.dl4j_lstm_cluster_max_active(
                    b, h, fl._DTYPES[dtype], *plan)
                row[f"C{c}"] = {"ms": ms, "max_abs_err": err,
                                "resident_clusters": active}
            row["block_ms"] = graph_ms(launcher(
                lib, "dl4j_lstm_seq", ins, out, fl.lstm_plan(b, h)))
            chosen = fl.lstm_cluster_plan(b, h, dtype)
            print(f"sizes {str(dtype)[6:]} B{b} T{t} H{h} (the plan's C: "
                  f"{chosen.cluster if chosen else 'none'}): {row}",
                  flush=True)


def breakdown(gen):
    src = (_build.SRC_DIR / "fused_lstm.cu").read_text()
    out_dir = ROOT / "build" / "k4_sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, mods in VARIANTS.items():
        text = src
        for old, new in mods:
            if text.count(old) != 1:
                raise SystemExit(f"{name}: the source no longer has one "
                                 f"{old[:50]!r}")
            text = text.replace(old, new)
        cu = out_dir / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
             str(out_dir / f"{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc {name}: {log}")
        lib = ctypes.CDLL(str(out_dir / f"{name}.so"))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.dl4j_lstm_seq_cluster.argtypes = [p] * 6 + [i] * 8 + [p]
        libs[name] = lib
    b, h, dtype = 256, 256, torch.bfloat16
    plan = plan_args(fl.lstm_cluster_plan(b, h, dtype))
    ms = {}
    for t in (60, 240):
        ins = inputs(gen, b, t, h, dtype)
        out = torch.empty((b, t, h), dtype=dtype, device="cuda")
        ms[t] = {name: graph_ms(launcher(lib, "dl4j_lstm_seq_cluster", ins,
                                         out, plan))
                 for name, lib in libs.items()}
        print(f"breakdown bf16 B{b} H{h} T{t} ms: {ms[t]}", flush=True)
    step_us = {name: (ms[240][name] - ms[60][name]) / 180 * 1e3
               for name in VARIANTS}
    print(f"breakdown bf16 B{b} H{h} us a step (T 240 - T 60): {step_us}",
          flush=True)


def short_t(gen):
    """Both routes at short sequences: the cluster route loads its rw
    slice into shared memory before its first step, the block route
    streams rw from L2 at every step, so the block route may win below
    some T."""
    lib = fl._load()
    for dtype in (torch.bfloat16, torch.float32):
        for b, h in ((256, 256), (64, 256), (16, 256), (256, 128),
                     (16, 128), (512, 256), (1024, 256)):
            plan = plan_args(fl.lstm_cluster_plan(b, h, dtype))
            row, cross, slower = {}, None, 0
            for t in SHORT_T:
                ins = inputs(gen, b, t, h, dtype)
                out = torch.empty((b, t, h), dtype=dtype, device="cuda")
                cl = graph_ms(launcher(lib, "dl4j_lstm_seq_cluster", ins,
                                       out, plan))
                bl = graph_ms(launcher(lib, "dl4j_lstm_seq", ins, out,
                                       fl.lstm_plan(b, h)))
                route = fl.lstm_route(b, t, h, dtype)
                row[t] = {"cluster_ms": cl, "block_ms": bl, "route": route}
                slower += (route == "cluster") != (cl < bl)
                if cl < bl and cross is None:
                    cross = t
                elif cl >= bl:
                    cross = None
            print(f"short_t {str(dtype)[6:]} B{b} H{h} (the card holds "
                  f"{fl.cluster_max_active(b, h, dtype)} clusters, the grid "
                  f"has {-(-b // fl.CLUSTER_ROWS)}): the cluster route wins "
                  f"from T {cross} on; lstm_route takes the slower route at "
                  f"{slower} of {len(SHORT_T)} T; {row}", flush=True)


SHORT_T = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 60, 128)
PARTS = {"sizes": sizes, "breakdown": breakdown, "short_t": short_t}


def main():
    if not torch.cuda.is_available():
        print("k4_cluster_sweep: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for part in sys.argv[1:] or PARTS:
        PARTS[part](gen)
    return 0


if __name__ == "__main__":
    sys.exit(main())
