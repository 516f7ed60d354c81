"""Speculative decoding: draft-verify generation over the paged pool, with
page-exact rollback. Port of ``deeplearning4j_tpu/serving/spec.py``.

A cheap **draft** proposes ``k`` greedy tokens and the target model
verifies all of them in ONE dispatch of its chunk body
(``engine.verify_chunk``: the head over every row). Row ``i`` of the
verify logits is the target's next-token distribution after proposal
``i``, so the longest prefix of proposals that matches the target's own
argmax is accepted, and at the first mismatch the target's argmax is the
correction: a round emits ``accepted + 1`` tokens (``accepted`` when the
whole window matched) for one target dispatch. In greedy token space the
output is the plain decode's by construction; the promotion race holds it
anyway, since a reduction order could bite.

Rollback is a page-table operation: verify wrote the window's k/v into
the slot's mapped pages, so rejecting a tail is ``PageTable.trim`` (the
holds on pages past the accepted length drop; shared pages survive
through their other holders) plus a cursor rewind. Stale rows inside the
kept page lie past ``pos``, where the mask never reads and the next
append overwrites them. ``PageTable.check()`` holds after every round.

Two drafts:

- :class:`EngineDraft` — a (smaller) model with its own dense one-slot
  cache (``zoo.transformer.draft_params`` gives a layer-truncated one that
  shares embeddings and head with the target); a rollback is a cursor
  rewind (``engine.set_positions``, in place, since the compiled steps
  read the cursor at its address).
- :class:`NgramDraft` — prompt-lookup speculation: propose what followed
  the longest recent suffix match in the ids so far.

Promotion (:func:`race_spec`) is per draft arm and shape bucket through
the port's autotune store: an arm promotes only when its greedy tokens
are identical to :func:`plain_generate`'s, accepted tokens a step beat 1
AND its median wall time wins; otherwise the verdict is a fallback,
counted in ``dl4j_autotune_promotions_total``.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..kernels import autotune
from . import kvcache

__all__ = ["EngineDraft", "NgramDraft", "SpeculativeDecoder",
           "race_spec", "spec_bucket_key"]


def _registry():
    from ..obs import get_registry
    return get_registry()


def _argmax(logits) -> int:
    """The greedy token of one (V,) row of logits, read on the host."""
    return int(logits.float().argmax())


# ------------------------------------------------------------- drafts --

class EngineDraft:
    """Draft tokens from a (smaller) model with its own dense one-slot
    cache. ``propose`` decodes greedily from the shared context; when the
    target rejected a tail, the next ``propose`` sees the shorter context
    and rewinds its cursor — the rows of accepted tokens were written by
    the draft's own decode of those very tokens, and rejected rows lie
    past the cursor. The cache is allocated once and a new request
    prefills into it (the reference allocates one a request; on the card
    a new cache is a new graph signature)."""

    name = "engine"

    def __init__(self, engine):
        self.engine = engine
        self.cache = None
        self._pos: Optional[int] = None

    def reset(self):
        self._pos = None

    def propose(self, ids: Sequence[int], k: int) -> List[int]:
        eng = self.engine
        if self._pos is None:
            if self.cache is None:
                self.cache = eng.init_cache(1)
            _, self.cache = eng.prefill_slot(
                self.cache, np.asarray(ids[:-1], np.int32), 0)
            self._pos = len(ids) - 1
        want = len(ids) - 1
        if want != self._pos:
            if want > self._pos:
                raise ValueError(
                    f"draft cursor {self._pos} behind context {want}: "
                    "propose() must see every accepted token")
            eng.set_positions(self.cache, [0], want)
            self._pos = want
        out: List[int] = []
        last = int(ids[-1])
        for _ in range(k):
            logits, self.cache = eng.decode_step(
                self.cache, np.asarray([last], np.int32))
            last = _argmax(logits[0])
            out.append(last)
        self._pos += k
        return out


class NgramDraft:
    """Prompt-lookup speculation: the longest suffix of the context (up
    to ``n`` tokens) that occurred earlier proposes what followed it last
    time. Stateless: a rollback costs nothing."""

    name = "ngram"

    def __init__(self, n: int = 3):
        self.n = max(1, int(n))

    def reset(self):
        pass

    def propose(self, ids: Sequence[int], k: int) -> List[int]:
        ids = list(ids)
        t = len(ids)
        for n in range(min(self.n, t - 1), 0, -1):
            suffix = ids[t - n:]
            # the most recent earlier occurrence wins
            for i in range(t - n - 1, -1, -1):
                if ids[i:i + n] == suffix and i + n < t:
                    cont = ids[i + n:i + n + k]
                    if cont:
                        return (cont + [ids[-1]] * (k - len(cont)))[:k]
        return [ids[-1]] * k


# ------------------------------------------------------------ decoder --

class SpeculativeDecoder:
    """Greedy draft-verify generation of ONE request over a private paged
    pool. The target engine's ``verify_chunk`` judges ``k`` proposals a
    round; rejected tails roll back through ``PageTable.trim`` and a
    cursor rewind, refcounts exact (``check()`` holds after every round).

    ``preempt()`` releases every page mid-flight; ``resume()`` re-admits
    the accepted context through chunked prefill and generation goes on
    unchanged. ``cancel()`` is a preemption without the comeback."""

    def __init__(self, engine, draft, *, k: int = 4,
                 page_len: int = kvcache.DEFAULT_PAGE_LEN,
                 n_pages: Optional[int] = None,
                 quantized: Optional[bool] = None):
        if k < 1:
            raise ValueError("need k >= 1 draft proposals per round")
        if k >= engine.chunk_len:
            raise ValueError(f"k={k} proposals need a verify chunk of "
                             f"k rows <= chunk_len={engine.chunk_len}")
        self.engine = engine
        self.draft = draft
        self.k = int(k)
        per_slot = -(-engine.max_len // int(page_len))
        self.n_pages = int(per_slot if n_pages is None else n_pages)
        self.page_len = int(page_len)
        self.cache = engine.init_paged_cache(1, self.n_pages, page_len,
                                             quantized=quantized)
        self.table = kvcache.PageTable.for_cache(self.cache)
        self.rounds = 0
        self.proposed = 0
        self.accepted = 0
        self.rollback_pages = 0
        self._ids: List[int] = []
        self._emitted: List[int] = []

    # ------------------------------------------------------- plumbing
    def _set_pos(self, pos: int):
        self.engine.set_positions(self.cache, [0], int(pos))

    def _map_to(self, tokens: int):
        if not self.table.map(0, tokens):
            raise RuntimeError(
                f"speculation pool exhausted: {tokens} tokens need "
                f"{self.table.pages_for(tokens)} pages, "
                f"{self.table.free_pages} free")
        self.cache = self.table.sync(self.cache)

    def _prefill(self, ids: Sequence[int]):
        """Chunked prefill of ``ids`` into slot 0 (admission and the
        re-prefill after a preemption). Returns the last logits."""
        eng = self.engine
        n = len(ids)
        self._map_to(n)
        logits = None
        for start in range(0, n, eng.chunk_len):
            chunk = np.asarray(ids[start:start + eng.chunk_len], np.int32)
            logits, self.cache = eng.prefill_chunk(self.cache, chunk, 0,
                                                   start)
        self.table.note_fill(0, n)
        return logits

    # ------------------------------------------------------ lifecycle
    def release(self):
        """Drop every page hold (finish, cancel, preemption)."""
        self.table.release(0)
        self.cache = self.table.sync(self.cache)
        self._set_pos(0)

    def cancel(self):
        """Abandon the request: pages back to the free list, state
        cleared; ``check()`` holds right after."""
        self.release()
        self._ids = []
        self._emitted = []
        if hasattr(self.draft, "reset"):
            self.draft.reset()

    def preempt(self):
        """Lose every page mid-generation (the accepted context survives
        on the host in ``self._ids``)."""
        self.release()

    def resume(self):
        """Re-admit after :meth:`preempt`: chunked re-prefill of the
        accepted context (every id but the unwritten last)."""
        if not self._ids:
            raise RuntimeError("nothing to resume: no accepted context")
        self._prefill(self._ids[:-1])

    # ----------------------------------------------------- generation
    def stats(self) -> Dict:
        emitted = len(self._emitted)
        return {
            "rounds": self.rounds,
            "proposed": self.proposed,
            "accepted": self.accepted,
            "rollback_pages": self.rollback_pages,
            # tokens a VERIFY dispatch (the first token is the
            # prefill's, not a round's)
            "accepted_per_step": ((emitted - 1) / self.rounds
                                  if self.rounds else 0.0),
        }

    def generate(self, prompt_ids, max_new_tokens: int = 32, *,
                 eos_id: Optional[int] = None,
                 fault_hook=None) -> np.ndarray:
        """Greedy speculative generation; returns the generated ids
        (prompt excluded), the plain greedy decode's in token space.
        ``fault_hook(round, decoder)`` runs before each verify round and
        may preempt or cancel."""
        eng = self.engine
        prompt = [int(t) for t in np.asarray(prompt_ids, np.int32)
                  .reshape(-1)]
        if not prompt:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if len(prompt) + max_new_tokens - 1 > eng.max_len:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens "
                f"({max_new_tokens}) - 1 exceeds max_len={eng.max_len}")
        if hasattr(self.draft, "reset"):
            self.draft.reset()
        reg = _registry()
        c_rounds = reg.counter(
            "dl4j_spec_rounds_total",
            "Speculative verify rounds, by draft mode",
            labelnames=("mode",))
        c_proposed = reg.counter(
            "dl4j_spec_proposed_total",
            "Draft tokens proposed, by draft mode", labelnames=("mode",))
        c_accepted = reg.counter(
            "dl4j_spec_accepted_total",
            "Draft tokens the target accepted, by draft mode",
            labelnames=("mode",))
        c_rollback = reg.counter(
            "dl4j_spec_rollback_pages_total",
            "Page mappings rolled back on rejected speculation",
            labelnames=("mode",))
        mode = getattr(self.draft, "name", "draft")

        logits = self._prefill(prompt)
        t0 = _argmax(logits)
        ids = prompt + [t0]
        emitted = [t0]
        self._ids, self._emitted = ids, emitted
        rnd = 0
        while len(emitted) < max_new_tokens and \
                (eos_id is None or emitted[-1] != eos_id):
            if fault_hook is not None:
                fault_hook(rnd, self)
                if not self._ids:          # the hook cancelled us
                    break
            rnd += 1
            pos = len(ids) - 1             # resident rows
            r = min(self.k, max_new_tokens - len(emitted))
            drafts = [int(t) for t in self.draft.propose(ids, r)]
            self.proposed += r
            rows = [ids[-1]] + drafts[:r - 1]
            self._map_to(pos + r)
            logits_all, self.cache = eng.verify_chunk(self.cache, rows,
                                                      0, pos)
            g = logits_all[:r].float().argmax(-1).tolist()
            m = 0
            while m < r and drafts[m] == g[m]:
                m += 1
            new = drafts[:r] if m == r else drafts[:m] + [g[m]]
            self.accepted += m
            ids.extend(new)
            emitted.extend(new)
            # roll back the rejected tail: the resident rows are all but
            # the (never written) newest token
            new_pos = len(ids) - 1
            freed = self.table.trim(0, new_pos)
            self.rollback_pages += freed
            self.cache = self.table.sync(self.cache)
            self._set_pos(new_pos)
            self.table.note_fill(0, new_pos)
            self.rounds += 1
            c_rounds.inc(mode=mode)
            c_proposed.inc(r, mode=mode)
            c_accepted.inc(m, mode=mode)
            if freed:
                c_rollback.inc(freed, mode=mode)
        if eos_id is not None and eos_id in emitted:
            emitted = emitted[:emitted.index(eos_id) + 1]
        self._emitted = emitted
        return np.asarray(emitted, np.int32)


# ---------------------------------------------------------- promotion --

def spec_bucket_key(cfg, draft_name: str, k: int,
                    backend: str = "cuda") -> str:
    return (f"spec_decode:L{cfg.n_layers}H{cfg.n_heads}D{cfg.head_dim}"
            f":{draft_name}:K{int(k)}:{backend}")


def spec_sha() -> str:
    """Fingerprint of ``spec_decode:*`` cost records."""
    return autotune.source_sha(SpeculativeDecoder, EngineDraft,
                               NgramDraft)


def plain_generate(engine, prompt_ids, max_new_tokens: int, *,
                   page_len: int = kvcache.DEFAULT_PAGE_LEN, cache=None):
    """The non-speculative baseline of the race: greedy decode of one
    request over a private paged pool of the same geometry — chunked
    prefill, then one ``decode_step`` a token (K2 on the card). ``cache``
    is a one-slot pool to reuse, left with nothing mapped (its graphs
    stay warm); None allocates one. Returns (generated ids, seconds)."""
    prompt = np.asarray(prompt_ids, np.int32).reshape(-1)
    if cache is None:
        per_slot = -(-engine.max_len // int(page_len))
        cache = engine.init_paged_cache(1, per_slot, page_len)
    table = kvcache.PageTable.for_cache(cache)
    start = time.perf_counter()
    n = len(prompt)
    table.map(0, n + max_new_tokens - 1)
    cache = table.sync(cache)
    logits = None
    for s in range(0, n, engine.chunk_len):
        chunk = prompt[s:s + engine.chunk_len]
        logits, cache = engine.prefill_chunk(cache, chunk, 0, s)
    out = [_argmax(logits)]
    while len(out) < max_new_tokens:
        logits, cache = engine.decode_step(cache,
                                           np.asarray([out[-1]], np.int32))
        out.append(_argmax(logits[0]))
    elapsed = time.perf_counter() - start
    table.release(0)
    table.sync(cache)
    return np.asarray(out, np.int32), elapsed


def race_spec(engine, drafts: Dict[str, object], prompt_ids,
              max_new_tokens: int = 64, *, k: int = 4,
              reps: int = 3) -> Dict:
    """Race each draft arm against :func:`plain_generate` on one prompt.
    An arm promotes only when its tokens are identical to the
    baseline's, accepted tokens a step > 1, and its median wall time
    wins; the promoted arm of the best speedup is the choice, else
    ``"plain"``. The baseline and each arm keep one pool over their
    ``reps`` (the median leaves out the first rep's graph captures). Each arm's verdict is a sha-stamped record and counts
    into ``dl4j_autotune_promotions_total``."""
    cfg = engine.cfg
    backend = engine.device.type
    base_times = []
    base_tokens = None
    # one pool for every rep, as each arm's decoder keeps one
    pool = engine.init_paged_cache(1, -(-engine.max_len
                                        // kvcache.DEFAULT_PAGE_LEN),
                                   kvcache.DEFAULT_PAGE_LEN)
    for _ in range(max(1, reps)):
        base_tokens, dt = plain_generate(engine, prompt_ids,
                                         max_new_tokens, cache=pool)
        base_times.append(dt)
    base_s = float(np.median(base_times))

    arms: Dict[str, Dict] = {}
    for name, draft in drafts.items():
        times = []
        toks = None
        stats = None
        dec = SpeculativeDecoder(engine, draft, k=k)
        for _ in range(max(1, reps)):
            dec.rounds = dec.proposed = dec.accepted = 0
            dec.rollback_pages = 0
            t0 = time.perf_counter()
            toks = dec.generate(prompt_ids, max_new_tokens)
            times.append(time.perf_counter() - t0)
            stats = dec.stats()
            dec.release()
        arm_s = float(np.median(times))
        identical = (toks is not None and base_tokens is not None
                     and len(toks) == len(base_tokens)
                     and bool(np.array_equal(toks, base_tokens)))
        accept = float(stats["accepted_per_step"]) if stats else 0.0
        if not identical:
            verdict = "fallback_fidelity"
        elif accept <= 1.0 or arm_s >= base_s:
            verdict = "fallback_slower"
        else:
            verdict = "promoted"
        arms[name] = {
            "verdict": verdict, "spec_s": arm_s, "base_s": base_s,
            "speedup": round(base_s / arm_s, 3) if arm_s > 0 else None,
            "accepted_per_step": round(accept, 3),
            "bit_identical": identical,
            "stats": stats,
        }
        key = spec_bucket_key(cfg, name, k, backend)
        chosen = name if verdict == "promoted" else "plain"
        autotune.put(key, (chosen,), meta=dict(arms[name], backend=backend),
                     sha=spec_sha())
        _registry().counter(
            "dl4j_autotune_promotions_total",
            "Fidelity-gated kernel-vs-XLA promotion races, by verdict",
            labelnames=("kernel", "verdict")).inc(
                kernel="spec_decode", verdict=verdict)
    best = None
    for name, a in arms.items():
        if a["verdict"] == "promoted" and \
                (best is None or a["speedup"] > arms[best]["speedup"]):
            best = name
    return {"choice": best or "plain", "base_s": base_s,
            "tokens": int(len(base_tokens)), "arms": arms,
            "backend": backend}
