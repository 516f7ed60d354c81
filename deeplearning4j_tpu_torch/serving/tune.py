"""The serving-knob sweep into the port's autotune store. Port of
``deeplearning4j_tpu/serving/tune.py``.

The paged pool and chunked prefill have three knobs — ``page_len``
(tokens a KV page), ``prefill_chunk`` (prompt tokens a chunk dispatch) and
the decode sweep's slot count — and each trades granularity (less tail
waste, shorter pauses) against amortized dispatch. Which side wins is a
property of the shape, the dtype and the device, so each is measured
there: every candidate is timed with the marginal chain of
``kernels.autotune`` and the winner lands in the port's store as a cost
record, ``{"choice", "meta": {measured_at, best_s, measurements}}``,
keyed by shape, dtype and backend (``torch.device.type``).
:func:`recommended_serving_knobs` reads the records back.

Keys::

    serving_page_len:L{layers}H{heads}D{head_dim}:T{max_len}:S{slots}:{dtype}:{backend}
    serving_prefill_chunk:L{..}H{..}D{..}:T{prompt}:{dtype}:{backend}
    serving_decode_slots:L{..}H{..}D{..}:T{max_len}:{dtype}:{backend}

Run it:

    python -m deeplearning4j_tpu_torch.serving.tune [--device cpu]
    from deeplearning4j_tpu_torch.serving.tune import sweep_serving_knobs
    records = sweep_serving_knobs(engine)

Sweep before ``engine.mark_warm()`` (or on a scratch engine): every
candidate is a new pool geometry or batch shape, so on a warm engine each
one is a counted retrace.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from ..kernels import autotune as _at
from . import kvcache

PAGE_LEN_CANDIDATES: Tuple[int, ...] = (8, 16, 32, 64)
PREFILL_CHUNK_CANDIDATES: Tuple[int, ...] = (32, 64, 128, 256)
DECODE_SLOT_CANDIDATES: Tuple[int, ...] = (2, 4, 8, 16)


def _key(kind: str, cfg, backend: str, **dims) -> str:
    tail = ":".join(f"{k}{v}" for k, v in dims.items())
    return (f"serving_{kind}:L{cfg.n_layers}H{cfg.n_heads}"
            f"D{cfg.head_dim}:{tail}:{_at.dtype_name(cfg.dtype)}:{backend}")


def sweep_page_len(eng, *, slots: int = 4,
                   candidates: Sequence[int] = PAGE_LEN_CANDIDATES,
                   enabled: bool = True) -> int:
    """Time one paged decode sweep a candidate ``page_len`` and cache the
    winner. Each candidate's pool holds the SAME token budget (``slots ×
    max_len`` rows), so the comparison isolates the page granularity."""
    max_len = int(eng.max_len)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, eng.cfg.vocab_size, (slots,)).astype(np.int32)

    def make_run(cand):
        (plen,) = cand
        if plen > max_len:
            return None
        n_pages = slots * (-(-max_len // plen))
        cache = eng.init_paged_cache(slots, n_pages, plen)
        pt = kvcache.PageTable.for_cache(cache)
        for s in range(slots):
            # half-full slots (steady state), with headroom mapped so
            # the timed steps' writes land in live pages
            pt.map(s, min(max_len, max_len // 2 + 64))
        cache = pt.sync(cache)
        eng.set_positions(cache, range(slots), max_len // 2)

        def run():
            return eng.decode_step(cache, toks)[0]
        return run

    key = _key("page_len", eng.cfg, eng.device.type, T=max_len,
               S=slots)
    choice = _at.autotune(key, [(c,) for c in candidates], make_run,
                          enabled=enabled)
    return int(choice[0])


def sweep_prefill_chunk(eng, *, prompt_len: int = 512,
                        candidates: Sequence[int] = PREFILL_CHUNK_CANDIDATES,
                        enabled: bool = True) -> int:
    """Time a full chunked prefill of one ``prompt_len`` prompt a
    candidate chunk size and cache the winner: the whole admission's
    wall, so the dispatch-vs-granularity trade is measured end to end."""
    from .engine import GenerationEngine

    prompt_len = int(min(prompt_len, eng.max_len))
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, eng.cfg.vocab_size, (prompt_len,)).astype(
        np.int32)
    plen = kvcache.DEFAULT_PAGE_LEN

    def make_run(cand):
        (chunk,) = cand
        if chunk > prompt_len:
            return None
        # chunk_len is engine geometry (it fixes the chunk buckets): a
        # candidate gets its own engine on the same weights and device
        ce = GenerationEngine(eng.cfg, eng.params, max_len=eng.max_len,
                              prefill_buckets=eng.prefill_buckets,
                              prefill_chunk=chunk, device=eng.device)
        n_pages = -(-prompt_len // plen) + 1
        cache = ce.init_paged_cache(1, n_pages, plen)
        pt = kvcache.PageTable.for_cache(cache)
        pt.map(0, prompt_len)
        cache = pt.sync(cache)

        def run():
            logits = None
            ce.set_positions(cache, [0], 0)
            for start in range(0, prompt_len, chunk):
                n = min(chunk, prompt_len - start)
                logits, _ = ce.prefill_chunk(cache, prompt[start:start + n],
                                             0, start=start)
            return logits
        return run

    key = _key("prefill_chunk", eng.cfg, eng.device.type,
               T=prompt_len)
    choice = _at.autotune(key, [(c,) for c in candidates], make_run,
                          enabled=enabled)
    return int(choice[0])


def sweep_decode_slots(eng, *, total_tokens: int = 32,
                       candidates: Sequence[int] = DECODE_SLOT_CANDIDATES,
                       enabled: bool = True) -> int:
    """Time decoding the SAME total token budget at each slot count
    (``total_tokens/slots`` sweeps of ``slots`` tokens) and cache the
    winner: the throughput-optimal sweep width for this shape."""
    max_len = int(eng.max_len)
    rng = np.random.default_rng(0)

    def make_run(cand):
        (slots,) = cand
        if slots > total_tokens:
            return None
        steps = max(1, total_tokens // slots)
        toks = rng.integers(0, eng.cfg.vocab_size, (slots,)).astype(
            np.int32)
        cache = eng.init_cache(slots)
        eng.set_positions(cache, range(slots), max_len // 2)

        def run():
            logits = None
            for _ in range(steps):
                logits, _ = eng.decode_step(cache, toks)
            return logits
        return run

    key = _key("decode_slots", eng.cfg, eng.device.type,
               T=max_len)
    choice = _at.autotune(key, [(c,) for c in candidates], make_run,
                          enabled=enabled)
    return int(choice[0])


def sweep_serving_knobs(eng, *, enabled: bool = True,
                        prompt_len: int = 512,
                        page_lens: Sequence[int] = PAGE_LEN_CANDIDATES,
                        prefill_chunks: Sequence[int] =
                        PREFILL_CHUNK_CANDIDATES,
                        decode_slots: Sequence[int] = DECODE_SLOT_CANDIDATES
                        ) -> Dict[str, int]:
    """Run all three sweeps (over the given candidate lists) and return
    the chosen knobs. Each verdict is a cost record; a second run is a
    cache hit."""
    return {
        "page_len": sweep_page_len(eng, candidates=page_lens,
                                   enabled=enabled),
        "prefill_chunk": sweep_prefill_chunk(eng, prompt_len=prompt_len,
                                             candidates=prefill_chunks,
                                             enabled=enabled),
        "decode_slots": sweep_decode_slots(eng, candidates=decode_slots,
                                           enabled=enabled),
    }


def recommended_serving_knobs(cfg=None, *, max_len: Optional[int] = None
                              ) -> Dict[str, dict]:
    """The serving cost records read back: ``{key: {choice, meta}}`` for
    every ``serving_*`` key of the store (of ``cfg``'s shape when given,
    matched field for field, so that L2H4D16 never claims L2H4D160's
    records). This is how a default is cited: the choice with the
    measurements that reached it."""
    out: Dict[str, dict] = {}
    want = None
    if cfg is not None:
        want = f"L{cfg.n_layers}H{cfg.n_heads}D{cfg.head_dim}"
    for key, rec in _at.records(kind="serving").items():
        fields = key.split(":")
        if want is not None and want not in fields:
            continue
        if max_len is not None and f"T{int(max_len)}" not in fields:
            continue
        out[key] = {"choice": rec["choice"], "meta": rec["meta"]}
    return out


def _main(argv=None):
    """CLI: sweep a tiny config (or the 120M shape with --flagship) on
    the card (``--device cpu`` for the host) and print the records."""
    import argparse
    import json

    import torch

    from ..zoo import transformer as tfm
    from .engine import GenerationEngine

    ap = argparse.ArgumentParser(description="serving-knob autotune sweep")
    ap.add_argument("--flagship", action="store_true",
                    help="sweep the 120M serving shape (slow on the CPU)")
    ap.add_argument("--prompt-len", type=int, default=512)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    if args.flagship:
        cfg = tfm.TransformerConfig(vocab_size=32000, d_model=512,
                                    n_heads=8, n_layers=8, d_ff=2048,
                                    max_seq=1024, dtype=torch.bfloat16,
                                    remat=False)
    else:
        cfg = tfm.TransformerConfig(vocab_size=256, d_model=64, n_heads=4,
                                    n_layers=2, d_ff=128, max_seq=512,
                                    dtype=torch.float32, remat=False,
                                    attn_scores_bf16=False)
    eng = GenerationEngine(cfg, tfm.init_params(
        cfg, torch.Generator().manual_seed(0), device=args.device),
        device=args.device)
    knobs = sweep_serving_knobs(eng, prompt_len=args.prompt_len)
    print(json.dumps({"chosen": knobs,
                      "records": recommended_serving_knobs(cfg)},
                     indent=2))


if __name__ == "__main__":
    _main()
