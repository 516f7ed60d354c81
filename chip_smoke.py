#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``deeplearning4j_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py                  # every phase
    python3 chip_smoke.py --kernels-only   # build + kernel checks only
    python3 chip_smoke.py --profile        # also profile paged decode
    python3 chip_smoke.py --profile-train  # also profile one train step

Phases, each fatal on failure:

1. print the card's name and power limit; build every kernel from
   ``deeplearning4j_tpu_torch/csrc`` (one nvcc per source, in parallel);
2. K2 (paged decode) against its plain version at the 120M decode shapes,
   bf16 and f32 pools, over mapped, sentinel, partial-tail, CoW-shared and
   empty slots (the empty slot against zeros);
3. K1 (causal flash forward) against ``mha_reference``, O and lse, at
   T 1024/2048, plus the strided (B, T, H, D) layout the transformer uses,
   with ``F.scaled_dot_product_attention`` timed as a yardstick only;
3b. the flash backward kernels (dQ, dK/dV) against
   ``flash_attention_bwd_reference`` on the same inputs, through strided
   (B, T, H, D) views of one qkv buffer, at B1 H8 D64 T 1024/2048/4096
   bf16, T 2048 f32, T 200 causal and T 256 non-causal, and at the train
   path's B32 T1024 bf16; the autograd Function's grads against autograd
   through ``mha_reference``; SDPA's backward timed as a yardstick only;
4. the main path at full width: the 120M Transformer-LM with seeded
   random weights served by a dense and a paged
   ``ContinuousBatchingScheduler``; every request must resolve with its
   token count, the launch counts are set to 0 just before each run and
   read just after it, K1 must have launched in the dense run and K2 in
   the paged run, and one K1
   prefill and one K2 decode step must match the plain path (kernels off)
   with KL <= 1e-3 per row;
6. the training path at full width: the 120M LM of ``bench.py``'s
   ``transformer`` row (T 1024, bf16, fused loss, remat "save_attn"),
   batch 32 of seeded random ids, trained by ``make_train_step`` with
   AdamW (optax's defaults) on the kernel path (flash forward and
   backward kernels) and on the plain path (plain attention, f32
   scores) from identical params: step-1 grads within relative L2
   2e-2 per leaf, loss within 2e-2 nats at each of 5 steps and falling;
   the launch counts are set to 0 just before the kernel path and K1,
   dQ and dK/dV must launch in every step;
5. a ``kernels`` JSON line, then the result line (printed last).

Without a CUDA device it exits non-zero before printing any result.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12                # H100 SXM, NVIDIA data sheet
BWD_F32_ATOL = 1e-4                      # flash backward, f32 grads
BWD_BF16_REL_L2 = 1e-2                   # flash backward, bf16 grads
TRAIN_GRAD_REL_L2 = 2e-2                 # kernel vs plain path, per leaf
TRAIN_LOSS_ATOL = 2e-2                   # nats, at every step
PEAK_FLOPS = {torch.bfloat16: 989e12,    # dense tensor-core bf16
              torch.float32: 67e12}      # f32 outside the tensor cores
MAX_KL = 1e-3                            # the reference's PROMOTION_MAX_KL
ATOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
LSE_ATOL = 1e-3


def log(*a):
    print(*a, flush=True)


def bound_ms(nbytes, flops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def cuda_ms(fn, iters=20, warmup=3):
    """Mean device time of ``fn`` over ``iters`` back-to-back runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kl_rows(ref_logits, cand_logits):
    """Per-row KL(ref || cand) in nats, f32."""
    lp = torch.log_softmax(ref_logits.float(), dim=-1)
    lq = torch.log_softmax(cand_logits.float(), dim=-1)
    return (lp.exp() * (lp - lq)).sum(dim=-1)


# ---------------------------------------------------------------- phase 2

def check_paged(pa, dtype, gen):
    """K2 vs its plain version at the 120M decode shapes: 8 slots,
    page_len 16, H 8, Dh 64, max_len 2048 (128 table entries), contexts
    up to 1024. Timed over 4 layers' pools in turn, so each launch reads
    its pages from device memory rather than from L2."""
    dev = "cuda"
    n_layers, b, h, dh, plen, per_slot = 4, 8, 8, 64, 16, 128
    npg = b * per_slot
    k = torch.randn((n_layers, npg, plen, h, dh), generator=gen,
                    device=dev).to(dtype)
    v = torch.randn((n_layers, npg, plen, h, dh), generator=gen,
                    device=dev).to(dtype)
    q = torch.randn((b, h, dh), generator=gen, device=dev).to(dtype)
    perm = torch.randperm(npg, generator=torch.Generator().manual_seed(1))
    table = torch.full((b, per_slot), npg, dtype=torch.int32)
    pos = torch.zeros((b,), dtype=torch.int32)
    # slot: (cursor, case)
    cases = [(1023, "mapped"), (700, "partial-tail"), (5, "single-page"),
             (900, "cow-shared"), (0, "empty"), (511, "page-boundary"),
             (512, "page-start"), (333, "sentinel-after-cursor")]
    nxt = 0
    for s, (p, case) in enumerate(cases):
        pos[s] = p
        if case == "empty":
            continue                       # every entry stays the sentinel
        need = p // plen + 1               # pages up to the cursor only
        if case == "cow-shared":
            share = 20                     # first 20 pages shared w/ slot 0
            table[s, :share] = table[0, :share]
            table[s, share:need] = perm[nxt:nxt + need - share].int()
            nxt += need - share
        else:
            table[s, :need] = perm[nxt:nxt + need].int()
            nxt += need
    live = [s for s, (_, c) in enumerate(cases) if c != "empty"]
    # operations are per (slot, row); bytes per DISTINCT (page, row): the
    # CoW slot's shared pages need reading from device memory only once
    rows = sum(cases[s][0] + 1 for s in live)
    distinct_rows = len({(int(table[s, i // plen]), i % plen)
                         for s in live for i in range(cases[s][0] + 1)})
    table, pos = table.to(dev), pos.to(dev)
    empty = [s for s, (_, c) in enumerate(cases) if c == "empty"]
    out = pa.paged_attention(q, k[0], v[0], table, pos)
    ref = pa.paged_attention_reference(q, k[0], v[0], table, pos)
    torch.cuda.synchronize()
    err = (out[live].float() - ref[live].float()).abs().max().item()
    err_empty = out[empty].float().abs().max().item()
    ok = err <= ATOL[dtype] and err_empty == 0.0
    layer = [0]

    def run_kernel():
        layer[0] = (layer[0] + 1) % n_layers
        pa.paged_attention(q, k[layer[0]], v[layer[0]], table, pos)

    def run_plain():
        layer[0] = (layer[0] + 1) % n_layers
        pa.paged_attention_reference(q, k[layer[0]], v[layer[0]], table,
                                     pos)

    ms = cuda_ms(run_kernel, iters=50)
    plain_ms = cuda_ms(run_plain, iters=10)
    item = torch.finfo(dtype).bits // 8
    nbytes = (2 * distinct_rows * h * dh * item + 2 * b * h * dh * item
              + table.numel() * 4 + pos.numel() * 4)
    flops = 4 * rows * h * dh
    bms, by = bound_ms(nbytes, flops, dtype)
    log(f"K2 paged_attention {str(dtype)[6:]}: max_abs_err {err:.3e} "
        f"(atol {ATOL[dtype]}), empty slot max |out| {err_empty:.1e}, "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bms:.5f} ms "
        f"({by}), live rows {rows} ({distinct_rows} distinct) -> "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"K2 {dtype} disagrees with its plain version")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "rows": rows,
            "distinct_rows": distinct_rows}


# ---------------------------------------------------------------- phase 3

def check_flash(fa, dtype, b, t, gen, h=8, d=64):
    """K1 vs mha_reference (O and lse), causal, (B, H, T, D); the same
    inputs through the strided (B, T, H, D) entry point; SDPA timed."""
    dev = "cuda"
    q, k, v = (torch.randn((b, h, t, d), generator=gen, device=dev)
               .to(dtype) for _ in range(3))
    out, lse = fa.flash_attention_lse(q, k, v, causal=True)
    ref, ref_lse = fa.mha_reference_lse(q, k, v, causal=True)
    err = (out.float() - ref.float()).abs().max().item()
    lse_err = (lse - ref_lse).abs().max().item()
    # the transformer's layout: q/k/v as strided views of one qkv buffer
    qkv = torch.cat([x.transpose(1, 2).reshape(b, t, h * d)
                     for x in (q, k, v)], dim=-1)
    qn, kn, vn = (x.reshape(b, t, h, d) for x in qkv.chunk(3, dim=-1))
    out_ntc = fa.flash_attention_ntc(qn, kn, vn, causal=True)
    ntc_err = (out_ntc.transpose(1, 2).float() - ref.float()).abs().max() \
        .item()
    torch.cuda.synchronize()
    ok = (err <= ATOL[dtype] and ntc_err <= ATOL[dtype]
          and lse_err <= LSE_ATOL)
    ms = cuda_ms(lambda: fa.flash_attention_lse(q, k, v, causal=True))
    plain_ms = cuda_ms(lambda: fa.mha_reference_lse(q, k, v, causal=True),
                       iters=5)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = cuda_ms(lambda: sdpa(q, k, v, is_causal=True))
    item = torch.finfo(dtype).bits // 8
    nbytes = 4 * b * h * t * d * item + b * h * t * 4
    flops = 4 * b * h * d * t * (t + 1) // 2
    bms, by = bound_ms(nbytes, flops, dtype)
    log(f"K1 flash_attention_fwd {str(dtype)[6:]} B{b} H{h} T{t} D{d}: "
        f"O err {err:.3e}, ntc err {ntc_err:.3e} (atol {ATOL[dtype]}), "
        f"lse err {lse_err:.3e} (atol {LSE_ATOL}), kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound "
        f"{bms:.5f} ms ({by}) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"K1 {dtype} B{b} T{t} disagrees with "
                         "mha_reference")
    return {"max_abs_err": max(err, ntc_err), "lse_err": lse_err, "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bms, "bound_by": by}


# --------------------------------------------------------------- phase 3b

def rel_l2(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def grad_ok(got, ref, dtype):
    """f32: max |err| <= 1e-4; bf16: relative L2 <= 1e-2."""
    if dtype == torch.float32:
        return (got - ref).abs().max().item() <= BWD_F32_ATOL
    return rel_l2(got, ref) <= BWD_BF16_REL_L2


def bwd_bounds(dtype, b, h, t, d, causal):
    """(dq, dkv) bounds: operations 6 (dQ) and 8 (dK/dV) · D per live
    (query, key) pair; bytes each operand read once (q, k, v, dO, lse,
    delta) and each output written once."""
    pairs = b * h * (t * (t + 1) // 2 if causal else t * t)
    item = torch.finfo(dtype).bits // 8
    rows = b * h * t
    dq = bound_ms(5 * rows * d * item + 2 * rows * 4, 6 * d * pairs, dtype)
    dkv = bound_ms(6 * rows * d * item + 2 * rows * 4, 8 * d * pairs, dtype)
    return dq, dkv


def check_flash_bwd(fa, dtype, b, t, causal, gen, h=8, d=64):
    """The dQ and dK/dV kernels vs ``flash_attention_bwd_reference`` on
    the same inputs, q/k/v strided (B, T, H, D) views of one qkv buffer
    as in the transformer; the Function (K1 + both kernels) vs autograd
    through ``mha_reference``; kernel, plain and SDPA-backward times."""
    dev = "cuda"
    scale = d ** -0.5
    qkv = torch.randn((b, t, 3 * h * d), generator=gen, device=dev).to(dtype)
    q, k, v = (x.reshape(b, t, h, d) for x in qkv.chunk(3, dim=-1))
    do = torch.randn((b, t, h, d), generator=gen, device=dev).to(dtype)
    qh, kh, vh, doh = (x.transpose(1, 2) for x in (q, k, v, do))
    o, lse = fa.mha_reference_lse(qh, kh, vh, causal=causal)
    delta = (doh.float() * o.float()).sum(-1).contiguous()
    del o
    ref = fa.flash_attention_bwd_reference(qh, kh, vh, doh, lse, delta,
                                           scale, causal)
    dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, scale, causal,
                                   "bthd")
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale,
                                        causal, "bthd")
    torch.cuda.synchronize()
    got = [x.transpose(1, 2) for x in (dq, dk, dv)]
    ok = all(grad_ok(g, r, dtype) for g, r in zip(got, ref))
    err = [(g.float() - r.float()).abs().max().item()
           for g, r in zip(got, ref)]
    rel = [rel_l2(g, r) for g, r in zip(got, ref)]
    del ref, got, dq, dk, dv

    # the autograd Function against autograd through the plain forward
    x = qkv.detach().requires_grad_(True)
    views = [c.reshape(b, t, h, d) for c in x.chunk(3, dim=-1)]
    (g_fn,) = torch.autograd.grad(
        fa.flash_attention_ntc(*views, causal=causal), x, do)
    ref_out = fa.mha_reference(*(c.transpose(1, 2) for c in views),
                               causal=causal)
    (g_ref,) = torch.autograd.grad(ref_out, x, doh)
    del ref_out
    fn_ok = grad_ok(g_fn, g_ref, dtype)
    fn_rel = rel_l2(g_fn, g_ref)
    del g_fn, g_ref, x, views

    ms_dq = cuda_ms(lambda: fa.flash_attention_bwd_dq(
        q, k, v, do, lse, delta, scale, causal, "bthd"), iters=5, warmup=1)
    ms_dkv = cuda_ms(lambda: fa.flash_attention_bwd_dkv(
        q, k, v, do, lse, delta, scale, causal, "bthd"), iters=5, warmup=1)
    plain_ms = cuda_ms(lambda: fa.flash_attention_bwd_reference(
        qh, kh, vh, doh, lse, delta, scale, causal), iters=3, warmup=1)
    qs, ks, vs = (y.contiguous().requires_grad_(True) for y in (qh, kh, vh))
    out = torch.nn.functional.scaled_dot_product_attention(
        qs, ks, vs, is_causal=causal)
    doc = doh.contiguous()
    library_ms = cuda_ms(lambda: torch.autograd.grad(
        out, (qs, ks, vs), doc, retain_graph=True), iters=10)
    del out
    (bq, byq), (bkv, bykv) = bwd_bounds(dtype, b, h, t, d, causal)
    log(f"flash bwd {str(dtype)[6:]} B{b} H{h} T{t} D{d} "
        f"{'causal' if causal else 'non-causal'}: max_abs_err dq/dk/dv "
        f"{err[0]:.3e}/{err[1]:.3e}/{err[2]:.3e}, rel L2 {rel[0]:.2e}/"
        f"{rel[1]:.2e}/{rel[2]:.2e}, Function vs autograd rel L2 "
        f"{fn_rel:.2e}; dq {ms_dq:.4f} ms (bound {bq:.5f}, {byq}), dkv "
        f"{ms_dkv:.4f} ms (bound {bkv:.5f}, {bykv}), plain backward "
        f"{plain_ms:.4f} ms, sdpa backward {library_ms:.4f} ms -> "
        f"{'ok' if ok and fn_ok else 'FAIL'}")
    if not (ok and fn_ok):
        raise SystemExit(f"flash backward {dtype} B{b} T{t} causal={causal} "
                         "disagrees with the plain backward")
    return {"dq": {"max_abs_err": err[0], "ms": ms_dq, "bound_ms": bq,
                   "bound_by": byq},
            "dkv": {"max_abs_err": max(err[1:]), "ms": ms_dkv,
                    "bound_ms": bkv, "bound_by": bykv},
            "plain_ms": plain_ms, "library_ms": library_ms}


# ---------------------------------------------------------------- phase 4

def serve(sched, prompts, n_new):
    futs = [sched.submit(p, max_new_tokens=n_new) for p in prompts]
    t0 = time.perf_counter()
    sched.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    results = [f.result(timeout=0) for f in futs]
    for p, r in zip(prompts, results):
        if len(r.tokens) != n_new or r.finish_reason != "length":
            raise SystemExit(f"request of {len(p)} tokens resolved with "
                             f"{len(r.tokens)} tokens ({r.finish_reason})")
        if not ((r.tokens >= 0) & (r.tokens < 32000)).all():
            raise SystemExit("generated ids outside the vocabulary")
    sched.check_pages()
    st = sched.stats
    ttft = [r.ttft_s for r in results]
    return {"requests": len(results), "wall_s": wall,
            "decode_tok_per_s": st["decode_tokens"] / st["decode_s"],
            "decode_steps": st["decode_steps"],
            "ttft_mean_s": float(np.mean(ttft)),
            "ttft_max_s": float(np.max(ttft)),
            "preemptions": st["preemptions"]}


def main_path(fa, pa):
    from deeplearning4j_tpu_torch.serving import (
        ContinuousBatchingScheduler, GenerationEngine, PageTable)
    from deeplearning4j_tpu_torch.serving import kvcache
    from deeplearning4j_tpu_torch.zoo import transformer as tfm

    # the flagship 120M engine (bench.py's serving engine) at max_seq 2048
    cfg = tfm.TransformerConfig(vocab_size=32000, d_model=512, n_heads=8,
                                n_layers=8, d_ff=2048, max_seq=2048,
                                dtype=torch.bfloat16, remat=False)
    params = tfm.init_params(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    dense_prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
                     for n in (600, 900, 1200, 1500)]
    paged_prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
                     for n in (17, 140, 260, 385, 512, 640, 777, 900)]
    n_new = 32
    engine = GenerationEngine(cfg, params)

    # warm-up (cuBLAS handles, allocator) outside the counted run
    warm = ContinuousBatchingScheduler(engine, n_slots=1)
    serve(warm, [dense_prompts[0][:40]], 2)

    # each path's own counts: set to 0 just before it, read just after
    by_path = {}
    for path, sched, prompts in (
            ("dense", ContinuousBatchingScheduler(engine, n_slots=4),
             dense_prompts),
            ("paged", ContinuousBatchingScheduler(engine, n_slots=8,
                                                  page_len=16),
             paged_prompts)):
        fa.reset_launches()
        pa.reset_launches()
        res = serve(sched, prompts, n_new)
        by_path[path] = {"flash_attention_fwd": fa.LAUNCHES,
                         "paged_attention": pa.LAUNCHES}
        log(f"main path {path} ({sched.n_slots} slots, prompts "
            f"{min(map(len, prompts))}-{max(map(len, prompts))}, {n_new} "
            f"new): {json.dumps(res)}; launches {json.dumps(by_path[path])}")
    # K1 runs in the dense path's prefills (buckets >= 1024), K2 in the
    # paged path's decode sweeps
    for path, name in (("dense", "flash_attention_fwd"),
                       ("paged", "paged_attention")):
        if by_path[path][name] <= 0:
            raise SystemExit(f"kernel {name} was not launched on the "
                             f"{path} main path")

    # K1 prefill vs the plain attention arm (kernel off, f32 scores)
    plain_cfg = dataclasses.replace(cfg, use_flash_attention=False,
                                    attn_scores_bf16=False)
    plain_eng = GenerationEngine(plain_cfg, params)
    prompt = dense_prompts[-1]                 # 1500 → bucket 2048
    lk, _ = engine.prefill_slot(engine.init_cache(1), prompt, 0)
    lp, _ = plain_eng.prefill_slot(plain_eng.init_cache(1), prompt, 0)
    kl1 = kl_rows(lp[None], lk[None])
    # K2 decode step vs the gather path on identical paged caches
    on = GenerationEngine(cfg, params, paged_kernel="on")
    off = GenerationEngine(cfg, params, paged_kernel="off")
    cache = off.init_paged_cache(8, 8 * 128, 16)
    table = PageTable.for_cache(cache)
    for s, p in enumerate(paged_prompts):
        table.map(s, len(p) + 1)
        table.sync(cache)
        for c0 in range(0, len(p), off.chunk_len):
            _, cache = off.prefill_chunk(cache, p[c0:c0 + off.chunk_len], s,
                                         start=c0)
    twin = {name: t.clone() for name, t in cache.items()}
    toks = np.array([int(p[-1]) for p in paged_prompts], np.int32)
    l_on, _ = on.decode_step(twin, toks)
    l_off, _ = off.decode_step(cache, toks)
    kl2 = kl_rows(l_off, l_on)
    if not kvcache.is_paged(twin) or pa.decide(on, twin) != "kernel":
        raise SystemExit("the kernel-on engine did not pick the kernel")
    finite = bool(torch.isfinite(lk).all() and torch.isfinite(l_on).all())
    log(f"KL(plain || kernel): K1 prefill {kl1.max().item():.3e}, K2 decode "
        f"max over 8 rows {kl2.max().item():.3e} (limit {MAX_KL}); "
        f"argmax agree K1 {bool(lk.argmax() == lp.argmax())}, K2 "
        f"{(l_on.argmax(-1) == l_off.argmax(-1)).float().mean().item():.3f}")
    if not finite or kl1.max().item() > MAX_KL or kl2.max().item() > MAX_KL:
        raise SystemExit("full-width logits disagree with the plain path")
    return by_path


# ---------------------------------------------------------------- phase 6

def _named_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [nl for k, v in tree.items()
                for nl in _named_leaves(v, f"{prefix}/{k}")]
    return [(prefix, tree)]


def train_path(fa, pa, steps=5, batch=32, profile=False):
    """The 120M LM trained at full width on the kernel path and on the
    plain path from identical params and one batch."""
    from deeplearning4j_tpu_torch.zoo import transformer as tfm

    # bench.py's transformer row (bench.py:594-598)
    cfg = tfm.TransformerConfig(vocab_size=32000, d_model=512, n_heads=8,
                                n_layers=8, d_ff=2048, max_seq=1024,
                                dtype=torch.bfloat16, fused_loss=True,
                                remat=True, remat_policy="save_attn",
                                attn_scores_bf16=True)
    plain_cfg = dataclasses.replace(cfg, use_flash_attention=False,
                                    attn_scores_bf16=False)
    init = tfm.init_params(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    ids = rng.integers(0, cfg.vocab_size, (batch, cfg.max_seq))
    tgt = rng.integers(0, cfg.vocab_size, (batch, cfg.max_seq))
    ids, tgt = (torch.as_tensor(a, device="cuda") for a in (ids, tgt))
    tokens = batch * cfg.max_seq
    runs = {}
    for path, c in (("kernel", cfg), ("plain", plain_cfg)):
        params = {k: (v.clone() if torch.is_tensor(v)
                      else {n: w.clone() for n, w in v.items()})
                  for k, v in init.items()}
        opt = torch.optim.AdamW(tfm.param_leaves(params), lr=3e-4,
                                betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=1e-4)
        step = tfm.make_train_step(c, opt)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launches()
        pa.reset_launches()
        losses, secs, per_step = [], [], []
        for i in range(steps):
            before = (fa.LAUNCHES, fa.LAUNCHES_BWD_DQ, fa.LAUNCHES_BWD_DKV)
            t0 = time.perf_counter()
            loss = step(params, ids, tgt)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            losses.append(loss.item())
            after = (fa.LAUNCHES, fa.LAUNCHES_BWD_DQ, fa.LAUNCHES_BWD_DKV)
            per_step.append([a - b for a, b in zip(after, before)])
            if i == 0:
                grads = {n: p.grad.detach().clone()
                         for n, p in _named_leaves(params)}
        run = {"losses": losses, "step_s": secs,
               "tok_per_s_steps_2_5": tokens * (steps - 1) / sum(secs[1:]),
               "peak_alloc_gib": torch.cuda.max_memory_allocated() / 2**30,
               "launches_per_step": per_step,
               "paged_launches": pa.LAUNCHES}
        log(f"train {path} path (B{batch} T{cfg.max_seq}, "
            f"{'flash kernels' if c is cfg else 'plain attention'}): "
            f"{json.dumps(run)}")
        runs[path] = (run, grads)
        if profile and path == "kernel":
            profile_train_step(step, params, ids, tgt)
        del params, opt, step
        torch.cuda.empty_cache()

    (kr, kg), (pr, pg) = runs["kernel"], runs["plain"]
    rels = {n: rel_l2(kg[n], pg[n]) for n in pg}
    finite = all(bool(torch.isfinite(g).all()) for g in kg.values())
    worst = max(rels, key=rels.get)
    dloss = [abs(a - b) for a, b in zip(kr["losses"], pr["losses"])]
    counts_ok = all(min(c) > 0 for c in kr["launches_per_step"])
    falls = kr["losses"][-1] < kr["losses"][0] \
        and pr["losses"][-1] < pr["losses"][0]
    log(f"train kernel vs plain: step-1 grad rel L2 max {rels[worst]:.3e} "
        f"({worst}; limit {TRAIN_GRAD_REL_L2}), all finite {finite}; "
        f"|loss delta| per step {[f'{x:.2e}' for x in dloss]} (limit "
        f"{TRAIN_LOSS_ATOL}); loss falls {falls}; launches per step "
        f"[K1, dQ, dK/dV] {kr['launches_per_step']}")
    if not finite or rels[worst] > TRAIN_GRAD_REL_L2:
        raise SystemExit("train path: step-1 grads disagree with the plain "
                         "path")
    if max(dloss) > TRAIN_LOSS_ATOL or not falls:
        raise SystemExit("train path: losses disagree with the plain path "
                         "or do not fall")
    if not counts_ok:
        raise SystemExit("train path: a flash kernel was not launched in "
                         "every step")
    total = [sum(c[i] for c in kr["launches_per_step"]) for i in range(3)]
    return {"flash_attention_fwd": total[0], "flash_attention_bwd_dq":
            total[1], "flash_attention_bwd_dkv": total[2],
            "paged_attention": runs["kernel"][0]["paged_launches"]}


def profile_train_step(step, params, ids, tgt):
    """Where one kernel-path train step's device time goes: the top CUDA
    kernels by device time under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(params, ids, tgt)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    log("profile (train step, B32 T1024): " + json.dumps(
        device_rows(prof, wall, 1)))


def device_rows(prof, wall, steps):
    """Wall and device time per step, the device-busy share and the top
    CUDA kernels by device time, from a ``torch.profiler`` run."""
    rows = []
    for ev in prof.key_averages():
        # device rows only (kernels, copies): an operator's row carries
        # its kernels' time again as its own "self device time"
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
        if dev_us > 0:
            rows.append((dev_us, ev.key, ev.count))
    rows.sort(reverse=True)
    busy_us = sum(r[0] for r in rows)
    return {"steps": steps, "wall_ms_per_step": wall * 1e3 / steps,
            "device_ms_per_step": busy_us / 1e3 / steps,
            "device_busy_share": busy_us / (wall * 1e6),
            "top_kernels": [{"name": k[:80], "ms_per_step": us / 1e3 / steps,
                             "calls_per_step": n / steps}
                            for us, k, n in rows[:12]]}


def profile_decode(steps=10):
    """Where a paged decode step's time goes at full width: 8 decoding
    slots (contexts ~600), ``steps`` sweeps under ``torch.profiler``.
    Prints the wall time per sweep, the device-busy share and the top
    CUDA kernels by device time."""
    from torch.profiler import ProfilerActivity, profile
    from deeplearning4j_tpu_torch.serving import (
        ContinuousBatchingScheduler, GenerationEngine)
    from deeplearning4j_tpu_torch.zoo import transformer as tfm

    cfg = tfm.TransformerConfig(max_seq=2048, dtype=torch.bfloat16,
                                remat=False)
    params = tfm.init_params(cfg, torch.Generator().manual_seed(0))
    sched = ContinuousBatchingScheduler(GenerationEngine(cfg, params),
                                        n_slots=8, page_len=16)
    rng = np.random.default_rng(1)
    for _ in range(8):
        sched.submit(rng.integers(0, cfg.vocab_size, 600).astype(np.int32),
                     max_new_tokens=steps + 20)
    while any(r is None or r.pending is not None for r in sched.slots):
        sched.step()                 # admit + chunked prefill until decoding
    for _ in range(3):
        sched.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            sched.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out = device_rows(prof, wall, steps)
    log("profile (paged decode, 8 slots, ctx ~600): " + json.dumps(out))
    sched.run_until_idle()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after the kernel build and checks")
    ap.add_argument("--profile", action="store_true",
                    help="also profile paged decode sweeps (torch.profiler)")
    ap.add_argument("--profile-train", action="store_true",
                    help="also profile one kernel-path train step")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from deeplearning4j_tpu_torch.kernels import KERNEL_SOURCES, _build
    from deeplearning4j_tpu_torch.kernels import flash_attention as fa
    from deeplearning4j_tpu_torch.kernels import paged_attention as pa

    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 matmuls
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _build.build(KERNEL_SOURCES, verbose=True)
    log(f"built {len(KERNEL_SOURCES)} kernels in "
        f"{time.perf_counter() - t0:.1f} s")

    gen = torch.Generator(device="cuda").manual_seed(0)
    k2 = {dt: check_paged(pa, dt, gen)
          for dt in (torch.bfloat16, torch.float32)}
    k1 = {}
    for dt in (torch.bfloat16, torch.float32):
        for b, t in ((1, 1024), (1, 2048), (2, 2048)):
            k1[(dt, b, t)] = check_flash(fa, dt, b, t, gen)
    bwd = {}
    for dt, b, t, causal in (
            (torch.bfloat16, 1, 1024, True), (torch.bfloat16, 1, 2048, True),
            (torch.bfloat16, 1, 4096, True), (torch.float32, 1, 2048, True),
            (torch.bfloat16, 2, 200, True), (torch.float32, 2, 200, True),
            (torch.bfloat16, 2, 256, False), (torch.float32, 2, 256, False),
            (torch.bfloat16, 32, 1024, True)):       # the train path's
        bwd[(dt, b, t)] = check_flash_bwd(fa, dt, b, t, causal, gen)
        torch.cuda.empty_cache()
    if args.kernels_only:
        return 0

    by_path = main_path(fa, pa)
    by_path["train"] = train_path(fa, pa, profile=args.profile_train)
    main_k1 = k1[(torch.bfloat16, 1, 2048)]    # a dense prefill's shape
    main_k2 = k2[torch.bfloat16]
    main_bwd = bwd[(torch.bfloat16, 32, 1024)]  # the train path's shape
    kernels = [
        {"name": "flash_attention_fwd", "route": "cuda",
         "source": "deeplearning4j_tpu_torch/csrc/flash_attention_fwd.cu",
         "replaces": "deeplearning4j_tpu/kernels/flash_attention.py:51",
         "launches": sum(c["flash_attention_fwd"] for c in by_path.values()),
         "launches_by_path": {p: c["flash_attention_fwd"]
                              for p, c in by_path.items()},
         "max_abs_err": max(r["max_abs_err"] for (dt, _, _), r in k1.items()
                            if dt == torch.bfloat16),
         "ms": main_k1["ms"], "plain_ms": main_k1["plain_ms"],
         "bound_ms": main_k1["bound_ms"], "bound_by": main_k1["bound_by"],
         "library_ms": main_k1["library_ms"]},
        *({"name": f"flash_attention_bwd_{part}", "route": "cuda",
           "source": "deeplearning4j_tpu_torch/csrc/flash_attention_bwd.cu",
           "replaces": f"deeplearning4j_tpu/kernels/flash_attention.py:{line}",
           "launches": by_path["train"][f"flash_attention_bwd_{part}"],
           "launches_by_path": {
               "train": by_path["train"][f"flash_attention_bwd_{part}"]},
           "max_abs_err": max(r[part]["max_abs_err"]
                              for (dt, _, _), r in bwd.items()
                              if dt == torch.bfloat16),
           "ms": main_bwd[part]["ms"], "plain_ms": main_bwd["plain_ms"],
           "bound_ms": main_bwd[part]["bound_ms"],
           "bound_by": main_bwd[part]["bound_by"],
           "library_ms": main_bwd["library_ms"]}
          for part, line in (("dq", 146), ("dkv", 186))),
        {"name": "paged_attention", "route": "cuda",
         "source": "deeplearning4j_tpu_torch/csrc/paged_attention.cu",
         "replaces": "deeplearning4j_tpu/kernels/paged_attention.py:72",
         "launches": sum(c["paged_attention"] for c in by_path.values()),
         "launches_by_path": {p: c["paged_attention"]
                              for p, c in by_path.items()},
         "max_abs_err": main_k2["max_abs_err"],
         "ms": main_k2["ms"], "plain_ms": main_k2["plain_ms"],
         "bound_ms": main_k2["bound_ms"], "bound_by": main_k2["bound_by"],
         "library_ms": None},
    ]
    if args.profile:
        profile_decode()
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
