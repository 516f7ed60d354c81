"""Continuous-batching inference scheduler over a fixed decode-slot pool.
Port of the core of ``deeplearning4j_tpu/serving/scheduler.py``.

One ``GenerationEngine`` cache holds ``n_slots`` sequences; each
``step()`` interleaves

    admit:  free slot + queued request → per-slot prefill (dense) or a
            chunked prefill into mapped pages (paged), first token
            sampled from the prefill logits (TTFT)
    decode: ONE sweep advances every active slot a token; finished
            slots free at once for re-admission

and each request resolves a ``concurrent.futures.Future`` with a
:class:`GenerationResult`. Paged mode (``page_len``/``n_pages``) admits
on page availability, grows each slot's mapping a page at a time and
preempts under page pressure; ``starvation_ms`` preempts the request with
the most remaining budget when the queue head starves. Preemption is
recompute: the victim's context re-queues and re-prefills, which leaves
greedy output unchanged.

Not ported yet (each knob raises ``NotImplementedError``): the metrics
registry, spans, SLO tracking, the flight recorder, sampler
observability, typed request kinds (score/embed/beam/constrained), the
prefix cache and sessions, and int8 KV.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future, InvalidStateError
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from . import kvcache
from .engine import GenerationEngine

# reference knobs of planes this port has not reached yet
_UNPORTED_SCHEDULER_KNOBS = (
    "replica", "slo", "recorder_requests", "recorder_snapshots",
    "crash_dump_path", "trace_spans", "sample_obs_every", "prefix_cache",
    "quant_kv", "key")
_UNPORTED_SUBMIT_KNOBS = ("session_id", "kind", "beam_width", "pooling",
                          "token_mask")


@dataclass
class GenerationResult:
    """What a request's future resolves to."""
    tokens: np.ndarray          # generated ids, prompt excluded
    finish_reason: str          # "eos" | "length"
    request_id: int
    ttft_s: Optional[float]     # submit → first token
    latency_s: float            # submit → completion
    preemptions: int


@dataclass
class ServingRequest:
    id: int
    prompt: np.ndarray
    max_new_tokens: int
    temperature: float
    top_k: int
    eos_id: Optional[int]
    future: Future
    submitted_ts: float
    queued_ts: float            # reset on re-queue after preemption
    first_token_ts: Optional[float] = None
    generated: List[int] = field(default_factory=list)
    preemptions: int = 0
    # chunked-prefill state (paged mode): the context being prefilled
    # this admission and how many of its tokens are written; ``pending is
    # None`` means the slot is decoding (or dense mode)
    pending: Optional[np.ndarray] = None
    done_tokens: int = 0
    prefill_s: float = 0.0
    chunks: int = 0

    def context(self) -> np.ndarray:
        """Token ids to prefill on (re-)admission: the prompt plus
        everything generated so far (recompute preemption)."""
        if not self.generated:
            return self.prompt
        return np.concatenate(
            [self.prompt, np.asarray(self.generated, np.int32)])

    def remaining(self) -> int:
        return self.max_new_tokens - len(self.generated)


class ContinuousBatchingScheduler:
    """Slot-based admission + full-pool decode over one engine cache.

    ``step()`` performs one admit+decode iteration; ``run_until_idle()``
    loops it; ``start()``/``stop()`` run the same loop on a daemon thread
    for callers that ``submit`` from elsewhere. Metadata (queue/slots)
    lives under a short-held lock so submit never waits on device work; a
    second lock serializes step() iterations (the cache is updated in
    place — one dispatch at a time)."""

    def __init__(self, engine: GenerationEngine, n_slots: int = 4, *,
                 starvation_ms: Optional[float] = None,
                 generator: Optional[torch.Generator] = None,
                 page_len: Optional[int] = None,
                 n_pages: Optional[int] = None, **unported):
        for name in unported:
            if name in _UNPORTED_SCHEDULER_KNOBS:
                raise NotImplementedError(
                    f"ContinuousBatchingScheduler({name}=...) belongs to a "
                    "serving plane that is not ported yet")
            raise TypeError(f"unexpected keyword argument {name!r}")
        if n_slots < 1:
            raise ValueError("need at least one decode slot")
        self.engine = engine
        self.n_slots = int(n_slots)
        self.starvation_ms = starvation_ms
        self.paged = page_len is not None or n_pages is not None
        if self.paged:
            plen = int(page_len if page_len is not None
                       else kvcache.DEFAULT_PAGE_LEN)
            per_slot = -(-engine.max_len // plen)
            np_ = int(n_pages if n_pages is not None
                      else self.n_slots * per_slot)
            self.cache = engine.init_paged_cache(self.n_slots, np_, plen)
            self._pages: Optional[kvcache.PageTable] = \
                kvcache.PageTable.for_cache(self.cache)
        else:
            self.cache = engine.init_cache(self.n_slots)
            self._pages = None
        self.slots: List[Optional[ServingRequest]] = [None] * self.n_slots
        self._queue: deque = deque()
        self._draining = False
        self._lock = threading.RLock()
        self._step_lock = threading.Lock()
        self._gen = generator if generator is not None \
            else engine.make_generator()
        self._last_tokens = np.zeros((self.n_slots,), np.int32)
        # sampled tokens come back through one pinned buffer and one
        # event (made at the first read from the card)
        self._host_tokens: Optional[torch.Tensor] = None
        self._read_done: Optional[torch.cuda.Event] = None
        self._next_id = 0
        self._thread: Optional[threading.Thread] = None
        self._stop_evt = threading.Event()
        # plain counters in place of the reference's metrics registry
        # (decode_s: host wall time of the sweeps, each ending in the
        # sampled tokens' device→host copy)
        self.stats = {"requests": 0, "prefills": 0, "prefill_chunks": 0,
                      "decode_steps": 0, "decode_s": 0.0,
                      "decode_tokens": 0, "tokens": 0, "preemptions": 0,
                      "completions": 0, "cancelled": 0}

    # -------------------------------------------------------- submit
    def submit(self, prompt_ids, max_new_tokens: int = 32, *,
               temperature: float = 0.0, top_k: int = 0,
               eos_id: Optional[int] = None, **extra) -> Future:
        """Queue a generation request; returns a Future resolving to a
        :class:`GenerationResult`. Anything that could never run fails
        here with a ValueError."""
        for name in extra:
            if name in _UNPORTED_SUBMIT_KNOBS:
                raise NotImplementedError(
                    f"submit({name}=...) belongs to a serving plane that "
                    "is not ported yet")
        if extra:
            raise ValueError(
                f"submit() got unknown keyword argument(s) {sorted(extra)}; "
                "valid: temperature, top_k, eos_id")
        raw = np.asarray(prompt_ids)
        if raw.size and not np.issubdtype(raw.dtype, np.integer):
            raise ValueError("prompt_ids must be integer token ids "
                             f"(got dtype {raw.dtype})")
        prompt = raw.reshape(-1).astype(np.int32)
        if prompt.size < 1:
            raise ValueError("empty prompt")
        vocab = int(self.engine.cfg.vocab_size)
        if int(prompt.min()) < 0 or int(prompt.max()) >= vocab:
            raise ValueError(
                f"prompt ids outside the vocabulary [0, {vocab})")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        total = prompt.size + max_new_tokens - 1
        if total > self.engine.max_len:
            raise ValueError(
                f"prompt ({prompt.size}) + budget = {total} exceeds "
                f"the slot capacity max_len={self.engine.max_len}")
        if self.paged and self._pages.pages_for(total) > self._pages.n_pages:
            raise ValueError(
                f"request needs {self._pages.pages_for(total)} pages "
                f"({total} tokens at page_len={self._pages.page_len}) but "
                f"the pool holds {self._pages.n_pages} — it could never "
                "run even alone")
        now = time.perf_counter()
        fut: Future = Future()
        with self._lock:
            if self._draining:
                raise RuntimeError("scheduler is draining — submit to "
                                   "another replica")
            req = ServingRequest(
                id=self._next_id, prompt=prompt,
                max_new_tokens=int(max_new_tokens),
                temperature=float(temperature), top_k=int(top_k),
                eos_id=eos_id, future=fut, submitted_ts=now,
                queued_ts=now)
            self._next_id += 1
            self._queue.append(req)
            self.stats["requests"] += 1
        return fut

    # ---------------------------------------------------------- step
    def step(self) -> bool:
        """One scheduler iteration: preempt-if-starved, admit, decode.
        Returns True if any work happened (False = fully idle)."""
        with self._step_lock:
            with self._lock:
                did = self._maybe_preempt()
                admissions = self._pop_admissions()
            if self.paged:
                # every prefilling slot advances ONE chunk, then the sweep
                did = self._advance_prefills() or did
            else:
                for slot, req in admissions:
                    self._admit_one(slot, req)
            did = did or bool(admissions)
            did = self._decode_sweep() or did
        return did

    def run_until_idle(self, max_steps: int = 100000):
        """Drive step() until queue and pool are empty."""
        for _ in range(max_steps):
            with self._lock:
                idle = not self._queue and not any(self.slots)
            if idle:
                return
            self.step()
        raise RuntimeError(f"scheduler not idle after {max_steps} steps")

    # ---------------------------------------------------- background
    def start(self, poll_s: float = 0.001):
        """Serve from a daemon thread until stop(): step() when there is
        work, sleep ``poll_s`` when idle."""
        if self._thread is not None:
            return self
        if not getattr(self, "_atexit_registered", False):
            import atexit
            import weakref
            ref = weakref.ref(self)
            atexit.register(lambda: (lambda s: s and s.stop())(ref()))
            self._atexit_registered = True
        self._stop_evt.clear()

        def loop():
            while not self._stop_evt.is_set():
                try:
                    worked = self.step()
                except Exception as e:  # noqa: BLE001 — a dying serve
                    # thread must FAIL the in-flight futures, not strand
                    # their callers on result() forever
                    self._fail_all(e)
                    raise
                if not worked:
                    self._stop_evt.wait(poll_s)

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="dl4j-torch-serving-scheduler")
        self._thread.start()
        return self

    def _fail_all(self, exc: BaseException):
        """Resolve every queued and in-flight future with ``exc`` and
        clear the pool (the serve-loop crash path)."""
        with self._lock:
            doomed = [r for r in self.slots if r is not None]
            doomed += list(self._queue)
            self.slots = [None] * self.n_slots
            self._queue.clear()
            if self.paged:
                self._pages.reset()
        for req in doomed:
            try:
                req.future.set_exception(exc)
            except InvalidStateError:
                pass

    def stop(self):
        if self._thread is None:
            return
        self._stop_evt.set()
        self._thread.join(timeout=30)
        self._thread = None

    def drain(self, max_steps: int = 100000) -> List[ServingRequest]:
        """Graceful retire: stop admission, FINISH every request already
        in a slot, then hand back the still-unstarted queue entries."""
        with self._lock:
            self._draining = True
        try:
            for _ in range(max_steps):
                with self._lock:
                    busy = any(self.slots)
                if not busy:
                    break
                self.step()
            else:
                raise RuntimeError(
                    f"drain: pool not empty after {max_steps} steps")
            with self._lock:
                leftover = list(self._queue)
                self._queue.clear()
            return leftover
        finally:
            with self._lock:
                self._draining = False

    # ------------------------------------------------------ internals
    def _free_slots(self):
        return [i for i, r in enumerate(self.slots) if r is None]

    def _first_chunk_pages(self, req) -> int:
        """Pages the request's first prefill chunk needs (paged)."""
        ctx_len = req.prompt.size + len(req.generated)
        return self._pages.pages_for(min(ctx_len, self.engine.chunk_len))

    def _preempt_slot(self, victim_slot: int) -> ServingRequest:
        """Preempt the request in ``victim_slot`` (caller holds
        ``_lock``): free the lane and its pages, reset mid-prefill
        progress, and re-queue its context at the BACK."""
        victim = self.slots[victim_slot]
        self.slots[victim_slot] = None
        if self.paged:
            self._pages.release(victim_slot)
        victim.pending = None
        victim.done_tokens = 0
        victim.preemptions += 1
        victim.queued_ts = time.perf_counter()
        self._queue.append(victim)
        self.stats["preemptions"] += 1
        return victim

    def _retire_slot(self, slot: int) -> int:
        """Finish-path page release (caller holds ``_lock``). Returns the
        mappings removed."""
        return self._pages.release(slot) if self.paged else 0

    def _maybe_preempt(self) -> bool:
        """Starvation guard: the queue head waited past the deadline and
        cannot admit → preempt the decoding request with the most
        remaining budget."""
        if self.starvation_ms is None or not self._queue or self._draining:
            return False
        if self._free_slots() and not (
                self.paged and self._first_chunk_pages(self._queue[0])
                > self._pages.free_pages):
            return False
        waited_ms = (time.perf_counter() - self._queue[0].queued_ts) * 1e3
        if waited_ms <= self.starvation_ms:
            return False
        victim_slot = max(
            (i for i, r in enumerate(self.slots)
             if r is not None and r.pending is None),
            key=lambda i: self.slots[i].remaining(), default=None)
        if victim_slot is None:
            return False
        victim = self.slots[victim_slot]
        if victim.remaining() <= 0 or not victim.generated:
            return False       # nothing to save / about to finish anyway
        self._preempt_slot(victim_slot)
        return True

    def _pop_admissions(self):
        """Under the metadata lock: pair free slots with queued requests
        and reserve the slots. A request whose future was cancelled while
        queued is dropped here. Paged mode also gates on the head's first
        chunk fitting the free list (FIFO holds)."""
        out = []
        if self._draining:
            return out
        reserved = 0
        while self._queue:
            req = self._queue[0]
            free = self._free_slots()
            if not free:
                break
            if self.paged:
                need = self._first_chunk_pages(req)
                if need > self._pages.free_pages - reserved:
                    break
            self._queue.popleft()
            # a re-queued preemption victim is already RUNNING
            if not req.future.running() and \
                    not req.future.set_running_or_notify_cancel():
                self.stats["cancelled"] += 1
                continue
            slot = free[0]
            if self.paged:
                req.pending = req.context()
                req.done_tokens = 0
                req.prefill_s = 0.0
                req.chunks = 0
                reserved += need
            self.slots[slot] = req
            out.append((slot, req))
        return out

    def _admit_one(self, slot, req):
        """Dense admission: prefill the whole context into the slot and
        sample the first token (TTFT)."""
        ctx = req.context()
        t0 = time.perf_counter()
        logits, self.cache = self.engine.prefill_slot(self.cache, ctx, slot)
        self._first_token(slot, req, logits, time.perf_counter() - t0)

    def _advance_prefills(self) -> bool:
        """Paged mode: advance every prefilling slot by ONE chunk. Pages
        for the chunk are mapped first (preempting under pressure); the
        final chunk samples the first token."""
        with self._lock:
            work = [(i, r) for i, r in enumerate(self.slots)
                    if r is not None and r.pending is not None]
        did = False
        for slot, req in work:
            with self._lock:
                if self.slots[slot] is not req:   # preempted meanwhile
                    continue
                ctx = req.pending
                done = req.done_tokens
                n = min(self.engine.chunk_len, len(ctx) - done)
                ok = self._ensure_pages(slot, req, done + n) \
                    and self.slots[slot] is req
            did = True
            if not ok:
                continue        # a preemption shuffle IS work
            self._pages.sync(self.cache)
            t0 = time.perf_counter()
            logits, self.cache = self.engine.prefill_chunk(
                self.cache, ctx[done:done + n], slot, start=done)
            elapsed = time.perf_counter() - t0
            with self._lock:
                req.prefill_s += elapsed
                req.chunks += 1
                req.done_tokens = done + n
                final = req.done_tokens >= len(ctx)
                if final:
                    req.pending = None
                self.stats["prefill_chunks"] += 1
            if final:
                self._first_token(slot, req, logits, req.prefill_s)
        return did

    def _ensure_pages(self, slot, req, tokens: int) -> bool:
        """Grow ``slot``'s mapping to cover ``tokens`` rows, preempting
        under page pressure (caller holds ``_lock``). Victims: decoding
        slots first, most remaining budget first; then mid-prefill slots,
        least progress first. If the pool still cannot cover the growth,
        ``req`` itself is preempted (False)."""
        if self._pages.map(slot, tokens):
            return True
        while True:
            victim_slot = max(
                (i for i, r in enumerate(self.slots)
                 if r is not None and i != slot),
                key=lambda i: (self.slots[i].pending is None,
                               -self.slots[i].done_tokens
                               if self.slots[i].pending is not None
                               else self.slots[i].remaining()),
                default=None)
            if victim_slot is None:
                break
            self._preempt_slot(victim_slot)
            if self._pages.map(slot, tokens):
                return True
        self._preempt_slot(slot)
        return False

    def _first_token(self, slot, req, logits, prefill_s: float):
        """Shared admission tail: sample the first token (the TTFT
        sample), then park it for the next sweep or finish at once."""
        tok = int(self._read_tokens(self.engine.sample(
            logits[None], req.temperature, req.top_k, self._gen))[0])
        now = time.perf_counter()
        with self._lock:
            self.stats["prefills"] += 1
            if req.first_token_ts is None:
                req.first_token_ts = now
            req.generated.append(tok)
            self.stats["tokens"] += 1
            if self._done(req, tok):
                self.slots[slot] = None
                self._retire_slot(slot)
                self._finish(req, tok)
            else:
                self._last_tokens[slot] = tok

    def _decode_sweep(self) -> bool:
        with self._lock:      # snapshot; only step() (serialized) mutates
            if self.paged:
                # page growth BEFORE the sweep: each decoding slot's next
                # write position must be mapped; under pressure
                # _ensure_pages preempts, so re-derive the active set
                for i in range(self.n_slots):
                    req = self.slots[i]
                    if req is None or req.pending is not None:
                        continue
                    self._ensure_pages(i, req, self._slot_tokens(req))
            active = [i for i, r in enumerate(self.slots)
                      if r is not None and r.pending is None]
            if not active:
                return False
            temps = np.zeros((self.n_slots,), np.float32)
            topks = np.zeros((self.n_slots,), np.int64)
            for i in active:
                temps[i] = self.slots[i].temperature
                topks[i] = self.slots[i].top_k
            tokens_in = self._last_tokens.copy()
        if self.paged:
            self._pages.sync(self.cache)
        t0 = time.perf_counter()
        logits, self.cache = self.engine.decode_step(self.cache, tokens_in)
        toks = self._read_tokens(self.engine.sample(logits, temps, topks,
                                                    self._gen))
        dt = time.perf_counter() - t0
        with self._lock:
            self.stats["decode_steps"] += 1
            self.stats["decode_s"] += dt
            self.stats["decode_tokens"] += len(active)
            self.stats["tokens"] += len(active)
            for i in active:
                req = self.slots[i]
                if req is None:
                    continue
                tok = int(toks[i])
                req.generated.append(tok)
                self._last_tokens[i] = tok
                if self._done(req, tok):
                    self.slots[i] = None
                    self._retire_slot(i)
                    self._finish(req, tok)
        return True

    def _read_tokens(self, toks: torch.Tensor) -> np.ndarray:
        """Sampled tokens (n,) → host numpy. From the card: one copy
        into the scheduler's pinned buffer and a wait on one event (only
        this stream's work up to the copy, not the whole device)."""
        if not toks.is_cuda:
            return toks.numpy().copy()
        if self._host_tokens is None:
            self._host_tokens = torch.empty((self.n_slots,),
                                            dtype=torch.int32,
                                            pin_memory=True)
            self._read_done = torch.cuda.Event()
        host = self._host_tokens[:toks.shape[0]]
        host.copy_(toks, non_blocking=True)
        self._read_done.record(torch.cuda.current_stream(toks.device))
        self._read_done.synchronize()
        return host.numpy().copy()

    @staticmethod
    def _done(req: ServingRequest, tok: int) -> bool:
        return (req.eos_id is not None and tok == req.eos_id) \
            or len(req.generated) >= req.max_new_tokens

    @staticmethod
    def _slot_tokens(r: ServingRequest) -> int:
        """Tokens a slot holding ``r`` accounts for: chunk progress while
        prefilling, prompt + generated when decoding."""
        if r.pending is not None:
            return r.done_tokens
        return r.prompt.size + len(r.generated)

    def _finish(self, req: ServingRequest, last_tok: int):
        reason = "eos" if (req.eos_id is not None
                           and last_tok == req.eos_id) else "length"
        now = time.perf_counter()
        self.stats["completions"] += 1
        try:
            req.future.set_result(GenerationResult(
                tokens=np.asarray(req.generated, np.int32),
                finish_reason=reason, request_id=req.id,
                ttft_s=(None if req.first_token_ts is None
                        else req.first_token_ts - req.submitted_ts),
                latency_s=now - req.submitted_ts,
                preemptions=req.preemptions))
        except InvalidStateError:
            pass   # the caller gave up on an in-flight request

    # ---------------------------------------------------- inspection
    def check_pages(self) -> bool:
        """Assert the free-XOR-refcounted page invariant. True for dense
        pools."""
        with self._lock:
            if not self.paged:
                return True
            return self._pages.check()
