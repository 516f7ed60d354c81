"""Continuous-batching inference scheduler over a fixed decode-slot pool.
Port of the core of ``deeplearning4j_tpu/serving/scheduler.py``.

One ``GenerationEngine`` cache holds ``n_slots`` sequences; each
``step()`` interleaves

    admit:  free slot + queued request → per-slot prefill (dense) or a
            chunked prefill into mapped pages (paged), first token
            sampled from the prefill logits (TTFT)
    decode: ONE sweep advances every active slot a token; finished
            slots free at once for re-admission

and each request resolves a ``concurrent.futures.Future``. Paged mode
(``page_len``/``n_pages``) admits on page availability, grows each slot's
mapping a page at a time and preempts under page pressure;
``starvation_ms`` preempts the request with the most remaining budget
when the queue head starves. Preemption is recompute: the victim's
context re-queues and re-prefills, which leaves greedy output unchanged.

On the paged pool:

- ``prefix_cache=True`` shares resident pages between requests: a
  :class:`~.kvcache.PrefixCache` indexes the full pages of every prefilled
  context by a chained hash, an admission maps the longest resident
  prefix of its prompt into its own table row and prefills only the tail,
  and a slot about to write into a page other holders share copies it
  first (``engine.copy_page``). ``submit(session_id=...)`` retains a
  finished turn's whole written context, so that the next turn of the
  conversation resumes append-only. Under page pressure cold cached
  pages are evicted (LRU) before any live request is preempted.
- ``submit(kind=...)`` types a request (:class:`~.workloads.RequestKind`):
  GENERATE; SCORE (per-token logprobs of the prompt, through
  ``engine.verify_chunk``); EMBED (the pooled post-``ln_f`` hidden state,
  through ``engine.embed_chunk``); BEAM (a width-k beam search whose lanes
  share the prompt's pages and split them on write); CONSTRAINED (a
  token mask applied inside ``engine.sample_masked``). CONSTRAINED runs
  on the dense pool too.

Every kind runs through the engine's compiled steps; the decode sweep of
a paged pool runs the paged-attention kernel (K2) on CUDA whatever pages
its slots share.

The observability plane rides on top, on the host only — the device
dispatch sequence is untouched, so greedy output is the same with
everything below on:

- ``dl4j_serving_*`` on the process registry (slot occupancy, queue
  depth, TTFT / queue-wait / ITL / latency / decode-sweep histograms,
  token, prefill, decode and preemption counters), ``dl4j_workload_*``
  by request kind, ``dl4j_kv_*`` residency (allocated vs resident bytes,
  the waste ratio, the prefix cache's sharing census), and the
  ``serving.prefill`` / ``serving.prefill_chunk`` /
  ``serving.score_chunk`` / ``serving.embed_chunk`` / ``serving.decode``
  spans; the instruments are resolved once, at construction;
- every request carries an ``obs.RequestTrace`` (submit → queue → admit
  → prefill → each token → preempt/requeue → finish/cancel/fail),
  stitched into the span tracer at completion (``trace_spans``) and
  feeding ``dl4j_serving_itl_seconds`` per request — a preemption's
  requeue gap is one (large) ITL sample;
- a bounded :class:`~..obs.FlightRecorder` keeps the last
  ``recorder_requests`` traces and ``recorder_snapshots`` per-step
  snapshots (slot map, queue, occupancy, per-kind census, residency),
  dumped as JSONL on demand and when the serve loop crashes
  (``_fail_all``, to ``crash_dump_path``);
- ``slo=SLOConfig(...)`` (or an ``SLOTracker``) accounts rolling goodput
  / attainment / burn rate (``dl4j_slo_*{replica}``, ``slo.report()``);
- a memory census at construction (params and KV under ``replica``);
- every ``sample_obs_every``-th sampling event (sweeps and first tokens
  share one counter; 0 disables) observes the model's next-token entropy
  and top-k mass (``dl4j_serving_sample_entropy``,
  ``dl4j_serving_topk_mass``), reduced where the logits are (on the
  card: two floats read back).

The bookkeeping self-times into ``trace_overhead_seconds`` as the
reference's does (trace events, snapshots, close-out, sampler).
``stats`` and ``kv_report()`` stay the plain readings of a run.

``quant_kv`` (off|on|auto|race) pins the paged pool's storage through
``serving.quant.decide_kv`` (the reference's ladder: int8 rows and scales
when on, or raced and promoted); it needs the paged pool. Every path —
CoW splits, prefix sharing, re-prefill, preemption — is blind to it: the
scales ride the page axis. SCORE requests score through ``verify_chunk``,
with the weights the engine decodes with.

Not taken (raises ``NotImplementedError``): ``key``, the reference's JAX
PRNG key, for which the port takes ``generator=``.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future, InvalidStateError
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from ..obs import (FlightRecorder, RequestTrace, SLOConfig, SLOTracker,
                   emit_census, get_registry, get_tracer)
from . import kvcache, quant, workloads
from .engine import GenerationEngine
from .workloads import (BeamResult, BeamState, EmbedResult, RequestKind,
                        ScoreResult)

# the reference knob this port does not take: ``key`` is a JAX PRNG key
# (the port takes ``generator=``)
_UNPORTED_SCHEDULER_KNOBS = ("key",)
# the parts of the plane's host cost the scheduler self-times
# (``_plane_s``; ``trace_overhead_seconds`` is the reference's share)
PLANE_PARTS = ("registry", "trace", "spans", "sampler", "slo")


@dataclass
class GenerationResult:
    """What a GENERATE or CONSTRAINED request's future resolves to."""
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
    trace: Optional[RequestTrace] = None
    # chunked-prefill state (paged mode): the context being prefilled
    # this admission and how many of its tokens are written; ``pending is
    # None`` means the slot is decoding (or dense mode)
    pending: Optional[np.ndarray] = None
    done_tokens: int = 0
    prefill_s: float = 0.0
    chunks: int = 0
    # prefix sharing: the session this request extends (its finish
    # retains pages under the same id)
    session_id: Optional[str] = None
    # the typed-request knobs and the per-kind state the scheduler keeps
    # on the host
    kind: RequestKind = RequestKind.GENERATE
    beam_width: int = 0
    pooling: str = "mean"
    token_mask: Optional[workloads.TokenMask] = None
    beam: Optional[BeamState] = None
    score_lps: List[float] = field(default_factory=list)
    embed_acc: Optional[np.ndarray] = None
    embed_last: Optional[np.ndarray] = None
    released_pages: int = 0

    def context(self) -> np.ndarray:
        """Token ids to prefill on (re-)admission: the prompt plus
        everything generated so far (recompute preemption)."""
        if not self.generated:
            return self.prompt
        return np.concatenate(
            [self.prompt, np.asarray(self.generated, np.int32)])

    def remaining(self) -> int:
        done = (self.beam.progress() if self.beam is not None
                else len(self.generated))
        return self.max_new_tokens - done


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
                 replica: str = "0",
                 slo: Union[SLOConfig, SLOTracker, None] = None,
                 recorder_requests: int = 256,
                 recorder_snapshots: int = 512,
                 crash_dump_path: Optional[str] = None,
                 trace_spans: bool = True,
                 sample_obs_every: int = 32,
                 page_len: Optional[int] = None,
                 n_pages: Optional[int] = None,
                 prefix_cache: bool = False,
                 quant_kv: Optional[str] = None, **unported):
        for name in unported:
            if name in _UNPORTED_SCHEDULER_KNOBS:
                raise NotImplementedError(
                    f"ContinuousBatchingScheduler({name}=...) is not ported "
                    "(the port takes generator= for key=)")
            raise TypeError(f"unexpected keyword argument {name!r}")
        if n_slots < 1:
            raise ValueError("need at least one decode slot")
        if prefix_cache and page_len is None and n_pages is None:
            raise ValueError("prefix_cache rides the paged pool: give "
                             "page_len and/or n_pages")
        if quant_kv is not None and page_len is None and n_pages is None:
            raise ValueError("quant_kv quantizes the paged pool: give "
                             "page_len and/or n_pages")
        self.engine = engine
        self.n_slots = int(n_slots)
        self.starvation_ms = starvation_ms
        self.replica = str(replica)
        self.paged = page_len is not None or n_pages is not None
        # sampler observability: every Nth sampling event (decode sweeps
        # and admission first tokens share one counter) observes the
        # model's next-token entropy and top-k mass (0 disables)
        self.sample_obs_every = max(0, int(sample_obs_every))
        self._obs_events = 0
        if self.paged:
            plen = int(page_len if page_len is not None
                       else kvcache.DEFAULT_PAGE_LEN)
            per_slot = -(-engine.max_len // plen)
            np_ = int(n_pages if n_pages is not None
                      else self.n_slots * per_slot)
            # int8 KV (quant_kv pins the mode; None defers to the
            # engine's ladder in quant.decide_kv)
            qz = None
            if quant_kv is not None:
                qz = quant.decide_kv(engine, self.n_slots, np_, plen,
                                     mode=quant_kv) == "int8"
            self.cache = engine.init_paged_cache(self.n_slots, np_, plen,
                                                 quantized=qz)
            self._pages: Optional[kvcache.PageTable] = \
                kvcache.PageTable.for_cache(self.cache)
            self._kv_page_bytes = kvcache.page_nbytes(self.cache)
        else:
            self.cache = engine.init_cache(self.n_slots)
            self._pages = None
            self._kv_page_bytes = 0
        self._gen = generator if generator is not None \
            else engine.make_generator()
        # a signature is warm after one call on the CPU, after its
        # capture (the second call) on the card
        reps = 2 if engine.device.type == "cuda" else 1
        # copy-on-write prefix sharing over the page pool (opt-in)
        self._prefix: Optional[kvcache.PrefixCache] = \
            kvcache.PrefixCache(self._pages) if prefix_cache else None
        if self.paged:
            # warm the page copy now (a self-copy changes nothing): the
            # first real split — of a shared prefix or of a beam's tail —
            # may come after mark_warm(), and a graph is a signature of
            # this cache, so no other scheduler's warm-up covers it
            for _ in range(reps):
                self.cache = engine.copy_page(self.cache, 0, 0)
        # warm the masked sampler at both sampling shapes — the sweep
        # (n_slots, V) and the first token (1, V) — so that the first
        # CONSTRAINED request after mark_warm() compiles nothing. A graph
        # holds its generator, so the warm-up draws from this one; its
        # state is put back, and seeded requests draw as without it
        vocab = int(engine.cfg.vocab_size)
        state = self._gen.get_state()
        for b in sorted({self.n_slots, 1}):
            for _ in range(reps):
                engine.sample_masked(
                    torch.zeros((b, vocab), device=engine.device),
                    np.zeros((b,), np.float32), np.zeros((b,), np.int64),
                    self._gen, np.ones((b, vocab), bool))
        self._gen.set_state(state)
        # KV residency accounting: allocated bytes are the static pool
        # under dense slotting and the MAPPED (with the prefix cache: the
        # held) pages under paging; resident bytes follow the host's
        # per-slot token counts (no device read)
        self._kv_allocated = kvcache.cache_nbytes(self.cache)
        self._kv_token_bytes = kvcache.token_nbytes(self.cache)
        self._kv_last_resident = 0
        self._kv_last_alloc = 0 if self.paged else self._kv_allocated
        self._kv_resident_sum = 0.0
        self._kv_alloc_sum = 0.0
        self._kv_samples = 0
        self._final_res_sum = 0.0
        self._final_res_n = 0
        self._peak_active = 0
        # the last published per-kind census, queue depth and allocated
        # bytes: a step writes these gauges only when their values move
        self._kind_census_pub: Dict[str, int] = {}
        self._kinds_last: Optional[Dict[str, int]] = None
        self._depth_pub: Optional[int] = None
        self._kv_pub_alloc: Optional[float] = None
        self.slots: List[Optional[ServingRequest]] = [None] * self.n_slots
        self._queue: deque = deque()
        self._draining = False
        self._lock = threading.RLock()
        self._step_lock = threading.Lock()
        self._last_tokens = np.zeros((self.n_slots,), np.int32)
        # sampled tokens come back through one pinned buffer and one
        # event (made at the first read from the card)
        self._host_tokens: Optional[torch.Tensor] = None
        self._read_done: Optional[torch.cuda.Event] = None
        self._next_id = 0
        self._thread: Optional[threading.Thread] = None
        self._stop_evt = threading.Event()
        # a run's plain readings beside the registry (decode_s: host wall
        # time of the sweeps, each ending in the sampled tokens'
        # device→host copy)
        self.stats = {"requests": 0, "prefills": 0, "prefill_chunks": 0,
                      "decode_steps": 0, "decode_s": 0.0,
                      "decode_tokens": 0, "tokens": 0, "preemptions": 0,
                      "completions": 0, "cancelled": 0}
        # the black box, per-request traces and the SLO tracker
        self.flight_recorder = FlightRecorder(
            capacity_requests=recorder_requests,
            capacity_snapshots=recorder_snapshots, replica=self.replica,
            crash_dump_path=crash_dump_path)
        self.flight_recorder.extra_state = self._debug_extra
        if isinstance(slo, SLOTracker):
            self.slo: Optional[SLOTracker] = slo
        elif slo is not None:
            self.slo = SLOTracker(slo, replica=self.replica)
        else:
            self.slo = None
        self.trace_spans = trace_spans
        self._steps = 0
        self._trace_overhead = 0.0
        self._plane_s = dict.fromkeys(PLANE_PARTS, 0.0)
        # every instrument resolved once, and the label sets the sweep
        # and the snapshot write: a step never looks one up
        self._mt = m = self._m()
        self._ch = {name: m[name].labels(replica=self.replica)
                    for name in ("occupancy", "queue_depth", "tokens_per_s",
                                 "kv_alloc", "kv_res", "kv_waste",
                                 "kv_shared", "kv_cached")}
        self._ch_tokens = {k: m["wl_tokens"].labels(kind=k)
                           for k in workloads.ALL_KINDS}
        self._ch_active = {k: m["active_kind"].labels(replica=self.replica,
                                                      kind=k)
                           for k in workloads.ALL_KINDS}
        # the pool's memory census, once (params and KV under this
        # replica's label), and the allocated-bytes gauge; decoration
        # only — a census failure must not take serving down
        try:
            emit_census({"params": engine.params, "kv_cache": self.cache},
                        replica=self.replica, source="serving")
            self._ch["kv_alloc"].set(float(self._kv_last_alloc))
        except Exception:  # noqa: BLE001 — census is decoration
            pass

    # ------------------------------------------------------- metrics
    @staticmethod
    def _m():
        reg = get_registry()
        return {
            "requests": reg.counter(
                "dl4j_serving_requests_total",
                "Requests submitted to the continuous-batching scheduler"),
            "completions": reg.counter(
                "dl4j_serving_completions_total",
                "Requests completed, by finish reason",
                labelnames=("reason",)),
            "preemptions": reg.counter(
                "dl4j_serving_preemptions_total",
                "Active requests preempted (recompute on re-admission)"),
            "prefills": reg.counter(
                "dl4j_serving_prefills_total",
                "Per-slot prefill admissions (includes re-admissions)"),
            "decode_steps": reg.counter(
                "dl4j_serving_decode_steps_total",
                "Full-pool decode sweeps executed"),
            "tokens": reg.counter(
                "dl4j_serving_tokens_total",
                "Tokens generated across all requests"),
            # the same request flow by RequestKind
            "wl_requests": reg.counter(
                "dl4j_workload_requests_total",
                "Requests submitted, by workload kind",
                labelnames=("kind",)),
            "wl_completions": reg.counter(
                "dl4j_workload_completions_total",
                "Requests completed (finish path), by workload kind",
                labelnames=("kind",)),
            "wl_tokens": reg.counter(
                "dl4j_workload_tokens_total",
                "Tokens processed per workload kind: generated tokens "
                "for generate/constrained, beam candidates for beam, "
                "prompt tokens scored/pooled for score/embed",
                labelnames=("kind",)),
            "active_kind": reg.gauge(
                "dl4j_serving_active_requests",
                "Admitted in-flight requests at the last snapshot, by "
                "workload kind (a beam group counts once)",
                labelnames=("replica", "kind")),
            "occupancy": reg.gauge(
                "dl4j_serving_slot_occupancy",
                "Active slots / pool size at the last decode sweep "
                "(0 when the pool is idle)",
                labelnames=("replica",)),
            "queue_depth": reg.gauge(
                "dl4j_serving_queue_depth",
                "Requests waiting for a decode slot",
                labelnames=("replica",)),
            "tokens_per_s": reg.gauge(
                "dl4j_serving_tokens_per_second",
                "Generated tokens per second over the last decode sweep "
                "(0 when the pool is idle)",
                labelnames=("replica",)),
            "ttft": reg.histogram(
                "dl4j_serving_ttft_seconds",
                "Time from submit to first generated token"),
            "queue_wait": reg.histogram(
                "dl4j_serving_queue_wait_seconds",
                "Time a request waited in the admission queue"),
            "decode_s": reg.histogram(
                "dl4j_serving_decode_step_seconds",
                "Wall time of one full-pool decode sweep"),
            "itl": reg.histogram(
                "dl4j_serving_itl_seconds",
                "Inter-token latency, derived per request from its "
                "lifecycle trace (a preemption requeue gap is one "
                "sample)"),
            "latency": reg.histogram(
                "dl4j_serving_request_latency_seconds",
                "Time from submit to request completion"),
            # KV residency: dense slots allocate max_len per slot, the
            # paged pool only its MAPPED pages
            "kv_alloc": reg.gauge(
                "dl4j_kv_allocated_bytes",
                "Allocated KV bytes: slots x max_len (dense slotting) "
                "or mapped pages x page bytes (paged pool)",
                labelnames=("replica",)),
            "kv_res": reg.gauge(
                "dl4j_kv_resident_bytes",
                "KV bytes actually holding tokens (active slots' "
                "prompt+generated counts x per-token bytes)",
                labelnames=("replica",)),
            "kv_waste": reg.gauge(
                "dl4j_kv_waste_ratio",
                "1 - resident/allocated (dense idle pool = 1.0; paged "
                "counts mapped pages, so waste is only unfilled page "
                "tails)", labelnames=("replica",)),
            # the prefix cache's sharing census — shared pages count ONCE
            # in kv_alloc above
            "kv_shared": reg.gauge(
                "dl4j_kv_shared_pages",
                "Pool pages with more than one holder (slot mappings + "
                "prefix-cache/session holds) at the last snapshot",
                labelnames=("replica",)),
            "kv_cached": reg.gauge(
                "dl4j_kv_cached_pages",
                "Pool pages resident only because the prefix cache "
                "holds them — the LRU-evictable reclaim headroom",
                labelnames=("replica",)),
            "kv_cow": reg.counter(
                "dl4j_kv_cow_copies_total",
                "Copy-on-write page splits (device page copies) before "
                "a slot scattered into a shared page"),
            "kv_prefix_hits": reg.counter(
                "dl4j_kv_prefix_hits_total",
                "Admissions that mapped a shared resident prefix "
                "instead of re-prefilling it"),
            "kv_prefix_hit_tokens": reg.counter(
                "dl4j_kv_prefix_hit_tokens_total",
                "Prompt tokens skipped at prefill because their pages "
                "were already resident (prefix/session hits)"),
            "kv_prefix_evictions": reg.counter(
                "dl4j_kv_prefix_evictions_total",
                "Cached prefix pages freed by LRU eviction under page "
                "pressure (before the preemption path)"),
            "kv_final": reg.histogram(
                "dl4j_kv_final_residency_ratio",
                "Per-request final residency at completion: "
                "(prompt+generated) / max_len under dense slotting, "
                "/ mapped-page capacity under paging — how much of "
                "what it reserved a request ever used",
                buckets=tuple(i / 20 for i in range(1, 21))),
            # the model's next-token distribution at the sampling sites
            "sample_entropy": reg.histogram(
                "dl4j_serving_sample_entropy",
                "Per-observation mean entropy (nats) of the MODEL's "
                "next-token distribution (softmax at temperature 1, "
                "before per-request temperature/top-k shaping) over "
                "active slots — the sharpness signal quantization "
                "drift shows up in, meaningful for greedy pools too",
                buckets=tuple(0.25 * i for i in range(1, 61))),
            "topk_mass": reg.histogram(
                "dl4j_serving_topk_mass",
                "Per-observation mean probability mass (at temperature "
                "1) the top-k truncation keeps, over active slots with "
                "top_k > 0",
                buckets=tuple(i / 20 for i in range(1, 21))),
        }

    # -------------------------------------------------------- submit
    def submit(self, prompt_ids, max_new_tokens: int = 32, *,
               temperature: float = 0.0, top_k: int = 0,
               eos_id: Optional[int] = None,
               session_id: Optional[str] = None,
               kind=RequestKind.GENERATE, beam_width: int = 0,
               pooling: str = "mean", token_mask=None,
               **extra) -> Future:
        """Queue a typed request; returns a Future resolving to a
        :class:`GenerationResult` (GENERATE, CONSTRAINED), a
        :class:`~.workloads.ScoreResult` (SCORE), an
        :class:`~.workloads.EmbedResult` (EMBED) or a
        :class:`~.workloads.BeamResult` (BEAM). Anything that could never
        run — a malformed prompt, an unknown keyword, a knob given with
        the wrong kind, a capacity overrun — fails here with a
        ValueError.

        ``kind`` takes the enum, its string value or its wire byte:

        - ``GENERATE`` — continuation;
        - ``SCORE`` — prefill-only per-token logprobs and perplexity of
          the prompt (paged pool; ``max_new_tokens`` is ignored);
        - ``EMBED`` — pooled post-``ln_f`` hidden state of the prompt
          (``pooling``: "mean" | "last"; paged pool; prefill-only);
        - ``BEAM`` — width-``beam_width`` (default 4) beam search; needs
          ``beam_width`` free lanes and the paged pool, where the beams
          share the prompt's pages copy-on-write;
        - ``CONSTRAINED`` — ``token_mask`` gates every sampled token: a
          fixed (V,) bool array or a callback ``step(generated_ids) ->
          (V,) bool`` (grammar stepping).

        ``session_id`` (needs ``prefix_cache=True``) threads a multi-turn
        conversation: at finish the request's written pages are retained
        under the id, and the next ``submit`` whose prompt extends the
        retained context maps them instead of prefilling the history
        again. Each turn's retention supersedes the last;
        :meth:`drop_session` releases it."""
        if extra:
            raise ValueError(
                f"submit() got unknown keyword argument(s) "
                f"{sorted(extra)}; valid: temperature, top_k, eos_id, "
                "session_id, kind, beam_width, pooling, token_mask")
        kind = RequestKind.coerce(kind)
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
        # a knob on the wrong kind fails loudly instead of doing nothing
        if beam_width and kind is not RequestKind.BEAM:
            raise ValueError("beam_width is a BEAM knob "
                             f"(got kind={kind.value!r})")
        if token_mask is not None and kind is not RequestKind.CONSTRAINED:
            raise ValueError("token_mask is a CONSTRAINED knob "
                             f"(got kind={kind.value!r})")
        if pooling != "mean" and kind is not RequestKind.EMBED:
            raise ValueError("pooling is an EMBED knob "
                             f"(got kind={kind.value!r})")
        if session_id is not None:
            if self._prefix is None:
                raise ValueError("session_id needs prefix_cache=True "
                                 "(and the paged pool)")
            if kind not in (RequestKind.GENERATE,
                            RequestKind.CONSTRAINED):
                raise ValueError("session_id threads multi-turn "
                                 "generate/constrained requests only "
                                 f"(got kind={kind.value!r})")
        if kind in (RequestKind.SCORE, RequestKind.EMBED,
                    RequestKind.BEAM) and not self.paged:
            raise ValueError(f"{kind.value} requests need the paged "
                             "pool (pass page_len and/or n_pages)")
        if kind is RequestKind.SCORE and prompt.size < 2:
            raise ValueError("scoring needs at least 2 tokens "
                             "(position 0 is unconditional)")
        if kind is RequestKind.EMBED \
                and pooling not in workloads.POOLING_WIRE:
            raise ValueError(f"unknown pooling {pooling!r}; expected "
                             f"one of {sorted(workloads.POOLING_WIRE)}")
        if kind is RequestKind.CONSTRAINED:
            if token_mask is None:
                raise ValueError("constrained decoding needs "
                                 "token_mask (array or callback)")
            if not callable(token_mask):
                # check and normalize a fixed mask once, here
                token_mask = workloads.resolve_mask(token_mask, [], vocab)
        if kind is RequestKind.BEAM:
            beam_width = int(beam_width) or 4
            if not 1 <= beam_width <= self.n_slots:
                raise ValueError(
                    f"beam_width {beam_width} outside "
                    f"[1, n_slots={self.n_slots}] — the whole group "
                    "admits together")
            if temperature > 0 or top_k > 0:
                raise ValueError("beam search ranks exact log-probs; "
                                 "temperature/top_k do not apply")
        else:
            beam_width = 0
        if kind in (RequestKind.SCORE, RequestKind.EMBED):
            # prefill-only: the request retires at its final chunk and
            # every prompt row's k/v is written (capacity = prompt)
            max_new_tokens = 1
            total = int(prompt.size)
        else:
            total = prompt.size + max_new_tokens - 1
        if total > self.engine.max_len:
            raise ValueError(
                f"prompt ({prompt.size}) + budget = {total} exceeds "
                f"the slot capacity max_len={self.engine.max_len}")
        if self.paged:
            full = self._pages.pages_for(total)
            if kind is RequestKind.BEAM:
                # the prompt's FULL pages are shared (one copy across the
                # group), only the divergent tail is per beam
                shr = prompt.size // self._pages.page_len
                need = shr + beam_width * (full - shr)
                if need > self._pages.n_pages:
                    raise ValueError(
                        f"beam fan-out needs {need} pages ({shr} "
                        f"shared prefix + {beam_width} x {full - shr} "
                        f"divergent) but the pool holds "
                        f"{self._pages.n_pages}")
            elif full > self._pages.n_pages:
                raise ValueError(
                    f"request needs {full} pages ({total} tokens at "
                    f"page_len={self._pages.page_len}) but the pool "
                    f"holds {self._pages.n_pages} — it could never "
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
                queued_ts=now, session_id=session_id, kind=kind,
                beam_width=beam_width, pooling=pooling,
                token_mask=token_mask)
            if kind is RequestKind.BEAM:
                req.beam = BeamState(width=beam_width)
            req.trace = RequestTrace(request_id=req.id,
                                     replica=self.replica,
                                     kind=kind.value)
            req.trace.event("submit", ts=now,
                            prompt_tokens=int(prompt.size),
                            max_new_tokens=int(max_new_tokens))
            req.trace.event("queue", ts=now)
            self._next_id += 1
            self._queue.append(req)
            self.stats["requests"] += 1
            m = self._mt
            t_reg = time.perf_counter()
            m["requests"].inc()
            m["wl_requests"].inc(kind=kind.value)
            self._depth_pub = len(self._queue)
            m["queue_depth"].set(self._depth_pub, replica=self.replica)
            self._plane_s["registry"] += time.perf_counter() - t_reg
        return fut

    # ---------------------------------------------------------- step
    def step(self) -> bool:
        """One scheduler iteration: preempt-if-starved, admit, decode.
        Returns True if any work happened (False = fully idle)."""
        with self._step_lock:
            m = self._mt
            with self._lock:
                did = self._maybe_preempt(m)
                admissions = self._pop_admissions(m)
            if self.paged:
                # every prefilling slot advances ONE chunk, then the sweep
                did = self._advance_prefills(m) or did
            else:
                for slot, req in admissions:
                    self._admit_one(slot, req, m)
            did = did or bool(admissions)
            did = self._decode_sweep(m) or did
            t_reg = time.perf_counter()
            with self._lock:
                depth = len(self._queue)
                if depth != self._depth_pub:     # a write only on change
                    self._depth_pub = depth
                    self._ch["queue_depth"].set(depth)
            self._plane_s["registry"] += time.perf_counter() - t_reg
            if did:
                t_ov = time.perf_counter()
                self._record_snapshot(m)
                dt = time.perf_counter() - t_ov
                self._trace_overhead += dt
                self._plane_s["trace"] += dt
            else:
                self._record_idle()
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
        """Resolve every queued and in-flight future with ``exc``, clear
        the pool, and leave a black box: a crash snapshot of the dying
        slot map and every doomed request's trace, dumped as JSONL (the
        serve-loop crash path). The futures fail FIRST, and none of the
        recording may mask ``exc``."""
        with self._lock:
            slot_ids = [None if r is None else r.id for r in self.slots]
            queued_ids = [r.id for r in self._queue]
            doomed, seen = [], set()
            for r in list(self.slots) + list(self._queue):
                # a beam group occupies several lanes — fail it ONCE
                if r is not None and r.id not in seen:
                    seen.add(r.id)
                    doomed.append(r)
            self.slots = [None] * self.n_slots
            self._queue.clear()
            if self.paged:
                self._pages.reset()
                if self._prefix is not None:
                    # reset() zeroed the refcounts the cache's holds
                    # backed: drop the bookkeeping without a decref
                    self._prefix.forget()
        for req in doomed:
            try:
                req.future.set_exception(exc)
            except InvalidStateError:
                pass
        err = repr(exc)[:300]
        try:
            m = self._mt
            self._steps += 1
            self.flight_recorder.record_snapshot(
                step=self._steps, crash=True, error=err, slots=slot_ids,
                queue=queued_ids, queue_depth=len(queued_ids),
                occupancy=sum(s is not None for s in slot_ids)
                / self.n_slots)
            for req in doomed:
                self._close_trace(req, "fail", m, error=err)
            self.flight_recorder.dump(reason="fail_all")
        except Exception:  # noqa: BLE001 — a failed postmortem (full
            pass           # disk, torn state) must not mask exc

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
                self._depth_pub = 0
                self._ch["queue_depth"].set(0)
            return leftover
        finally:
            with self._lock:
                self._draining = False

    # ------------------------------------------------------ internals
    def _free_slots(self):
        return [i for i, r in enumerate(self.slots) if r is None]

    def _admission_plan(self, req):
        """Paged-admission plan for ``req`` (caller holds ``_lock``):
        ``(shared_pages, matched_tokens, need)`` — the resident pages its
        prompt's prefix already has (the session's retention first, then
        the block index), the prompt tokens those cover, and the FREE
        pages its first prefill chunk still needs. The match stops at
        ``ctx_len - 1`` so that at least one token prefills: the final
        chunk's logits are the first-token sample."""
        ctx_len = req.prompt.size + len(req.generated)
        if self._prefix is None or req.kind in (RequestKind.SCORE,
                                                RequestKind.EMBED):
            # SCORE needs every position's logits and EMBED every
            # position's hidden row — a prefix hit would skip them
            return [], 0, self._pages.pages_for(
                min(ctx_len, self.engine.chunk_len))
        ctx = req.context()
        cap = ctx_len - 1
        shared: List[int] = []
        matched = 0
        if req.session_id is not None:
            sm = self._prefix.session_match(req.session_id, ctx)
            if sm is not None:
                n, shared = sm
                # an identical resubmit keeps the pages (the tail
                # position is rewritten into a copy) but leaves one token
                # to prefill
                matched = min(n, cap)
        if not shared:
            shared = self._prefix.match(ctx)
            while shared and len(shared) * self._pages.page_len > cap:
                shared.pop()
            matched = len(shared) * self._pages.page_len
        first_end = min(ctx_len, matched + self.engine.chunk_len)
        need = max(0, self._pages.pages_for(first_end) - len(shared))
        return shared, matched, need

    def _preempt_slot(self, victim_slot: int, m) -> ServingRequest:
        """Preempt the request in ``victim_slot`` (caller holds
        ``_lock``): free the lane and its pages, reset mid-prefill
        progress, and re-queue its context at the BACK. A beam request
        preempts as a GROUP (its lanes share pages and advance in
        lockstep); its rerun restarts from the prompt. Partial SCORE and
        EMBED tallies reset too."""
        victim = self.slots[victim_slot]
        if victim.beam is not None:
            for s in range(self.n_slots):
                if self.slots[s] is victim:
                    self.slots[s] = None
                    self._release_pages(s)
            victim.beam = BeamState(width=victim.beam_width)
            victim.released_pages = 0
        else:
            self.slots[victim_slot] = None
            self._release_pages(victim_slot)
        victim.score_lps = []
        victim.embed_acc = None
        victim.embed_last = None
        victim.pending = None
        victim.done_tokens = 0
        victim.preemptions += 1
        victim.queued_ts = time.perf_counter()
        if victim.trace is not None:
            victim.trace.event("preempt", ts=victim.queued_ts,
                               slot=victim_slot,
                               generated=len(victim.generated))
            victim.trace.event("requeue", ts=victim.queued_ts)
        self._queue.append(victim)
        self.stats["preemptions"] += 1
        m["preemptions"].inc()
        return victim

    def _release_pages(self, slot: int) -> int:
        """Drop the slot's page holds (paged; a no-op under dense
        slotting). Pages the prefix cache still holds stay resident."""
        return self._pages.release(slot) if self.paged else 0

    def _retire_slot(self, slot: int, req: ServingRequest) -> int:
        """Finish-path page release (caller holds ``_lock``). With the
        prefix cache the request's written context is registered first:
        full blocks into the index and, for a ``session_id`` request, the
        whole written mapping (partial tail page included) under the
        session. The last sampled token's k/v was never written, so the
        retained context stops one short. Preemption registers nothing
        (its point is to free pages). Returns the mappings removed."""
        if not self.paged:
            return 0
        if self._prefix is not None:
            ctx = req.context()
            written = int(ctx.size) - 1
            pages = self._pages.slot_pages(slot)
            if written > 0 and pages:
                self._pages.note_fill(slot, written)
                self._prefix.insert(ctx[:written], pages)
                if req.session_id is not None:
                    keep = self._pages.pages_for(written)
                    self._prefix.retain_session(
                        req.session_id, ctx[:written], pages[:keep])
        return self._pages.release(slot)

    def _maybe_preempt(self, m) -> bool:
        """Starvation guard: the queue head waited past the deadline and
        cannot admit (no free slot, or not enough free pages for its
        first chunk) → preempt the decoding request with the most
        remaining budget."""
        if self.starvation_ms is None or not self._queue or self._draining:
            return False
        if self._free_slots() and not (
                self.paged and self._admission_plan(self._queue[0])[2]
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
        progress = (victim.beam.progress() if victim.beam is not None
                    else len(victim.generated))
        if victim.remaining() <= 0 or not progress:
            return False       # nothing to save / about to finish anyway
        self._preempt_slot(victim_slot, m)
        return True

    def _pop_admissions(self, m):
        """Under the metadata lock: pair free slots with queued requests
        and reserve the slots. A request whose future was cancelled while
        queued is dropped here. Paged mode also gates on the head's first
        chunk fitting the free list, after evicting cold cached pages
        (FIFO holds). A BEAM head reserves its whole group — beam_width
        lanes — at once (the root lane prefills; the others wait for the
        fan-out) or waits."""
        out = []
        if self._draining:
            return out
        reserved = 0            # pages promised to this batch's heads
        while self._queue:
            req = self._queue[0]
            lanes = req.beam_width if req.kind is RequestKind.BEAM else 1
            free = self._free_slots()
            if len(free) < lanes:
                break
            shared: List[int] = []
            matched = need = 0
            if self.paged:
                shared, matched, need = self._admission_plan(req)
                if need > self._pages.free_pages - reserved:
                    # evict cold cached pages before refusing; the pages
                    # the head just matched are protected until mapped
                    if self._prefix is not None:
                        freed = self._prefix.evict(
                            need - (self._pages.free_pages - reserved),
                            protect=frozenset(shared))
                        if freed:
                            m["kv_prefix_evictions"].inc(freed)
                    if need > self._pages.free_pages - reserved:
                        break
            self._queue.popleft()
            # a re-queued preemption victim is already RUNNING
            if not req.future.running() and \
                    not req.future.set_running_or_notify_cancel():
                self.stats["cancelled"] += 1
                m["completions"].inc(reason="cancelled")
                self._close_trace(req, "cancel", m)
                continue
            slot = free[0]
            now = time.perf_counter()
            m["queue_wait"].observe(now - req.queued_ts)
            if req.trace is not None:
                req.trace.event("admit", ts=now, slot=slot)
            if self.paged:
                req.pending = req.context()
                req.done_tokens = 0
                req.prefill_s = 0.0
                req.chunks = 0
                if shared:
                    # map the matched prefix in the same lock hold as the
                    # plan (no eviction between): those tokens never
                    # prefill, the tail's chunks start past them
                    self._pages.map_shared(slot, shared)
                    self._pages.note_fill(slot, matched)
                    req.done_tokens = matched
                    self._prefix.note_hit(matched)
                    m["kv_prefix_hits"].inc()
                    m["kv_prefix_hit_tokens"].inc(matched)
                    if req.trace is not None:
                        req.trace.event(
                            "prefix_hit", ts=now,
                            matched_tokens=int(matched),
                            shared_pages=len(shared))
                reserved += need
            if req.kind is RequestKind.BEAM:
                # every lane of the group points at the one request;
                # only the root (beam.slots[0]) prefills
                req.beam = BeamState(width=lanes, slots=list(free[:lanes]))
                req.released_pages = 0
                for s in free[:lanes]:
                    self.slots[s] = req
            else:
                self.slots[slot] = req
            out.append((slot, req))
        return out

    def _admit_one(self, slot, req, m):
        """Dense admission: prefill the whole context into the slot and
        sample the first token (TTFT)."""
        ctx = req.context()
        t0 = time.perf_counter()
        with self._span("serving.prefill",
                        {"request": req.id, "slot": slot,
                         "tokens": int(ctx.size)}):
            logits, self.cache = self.engine.prefill_slot(self.cache, ctx,
                                                          slot)
        req.prefill_s = time.perf_counter() - t0
        self._first_token(slot, req, logits, int(ctx.size), req.prefill_s,
                          m)

    def _advance_prefills(self, m) -> bool:
        """Paged mode: advance every prefilling slot by ONE chunk. Pages
        for the chunk are mapped first (preempting under pressure) and
        shared pages it writes into are copied first. The final chunk
        ends the prefill by kind: GENERATE and CONSTRAINED sample their
        first token, SCORE and EMBED retire at once, BEAM fans out into
        its group. A beam group's other lanes never prefill."""
        with self._lock:
            work = [(i, r) for i, r in enumerate(self.slots)
                    if r is not None and r.pending is not None
                    and (r.beam is None
                         or (r.beam.slots and i == r.beam.slots[0]))]
        did = False
        for slot, req in work:
            with self._lock:
                if self.slots[slot] is not req:   # preempted meanwhile
                    continue
                ctx = req.pending
                done = req.done_tokens
                n = min(self.engine.chunk_len, len(ctx) - done)
                ok = self._ensure_pages(slot, req, done + n, m)
                # shared pages this chunk writes into split first:
                # planned under the lock, copied on the device outside it
                cows = self._plan_cow(slot, done, done + n, m) \
                    if ok and self.slots[slot] is req else []
                ok = ok and self.slots[slot] is req
            did = True
            if not ok:
                continue        # a preemption shuffle IS work
            for src, dst in cows:
                self.cache = self.engine.copy_page(self.cache, src, dst)
            self._pages.sync(self.cache)
            chunk = ctx[done:done + n]
            attrs = {"request": req.id, "slot": slot, "start": int(done),
                     "tokens": int(n)}
            t0 = time.perf_counter()
            logits = None
            if req.kind is RequestKind.SCORE:
                with self._span("serving.score_chunk", attrs):
                    rows, self.cache = self.engine.verify_chunk(
                        self.cache, chunk, slot, start=done)
                self._score_rows(req, ctx, done, n, _host(rows))
            elif req.kind is RequestKind.EMBED:
                with self._span("serving.embed_chunk", attrs):
                    rows, self.cache = self.engine.embed_chunk(
                        self.cache, chunk, slot, start=done)
                self._embed_rows(req, n, _host(rows))
            else:
                with self._span("serving.prefill_chunk", attrs):
                    logits, self.cache = self.engine.prefill_chunk(
                        self.cache, chunk, slot, start=done)
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
                if req.kind in (RequestKind.SCORE, RequestKind.EMBED):
                    self._finish_prefill_only(slot, req, m)
                elif req.beam is not None:
                    self._expand_beam(slot, req, logits, len(ctx),
                                      req.prefill_s, m)
                else:
                    self._first_token(slot, req, logits, len(ctx),
                                      req.prefill_s, m, chunks=req.chunks)
        return did

    @staticmethod
    def _score_rows(req, ctx, done: int, n: int, rows):
        """Fold one verify chunk's row logits (host f32) into the SCORE
        tally: row i (position ``done+i``) is the next-token distribution
        after ``ctx[:done+i+1]``, so it scores ``ctx[done+i+1]``; the
        context's final row has no target and is dropped."""
        tgt = np.asarray(ctx[done + 1: done + n + 1], np.int64)
        if not tgt.size:
            return
        lg = rows[:tgt.size]
        mx = lg.max(axis=-1, keepdims=True)
        lse = mx[:, 0] + np.log(np.exp(lg - mx).sum(axis=-1))
        req.score_lps.extend(
            (lg[np.arange(tgt.size), tgt] - lse).tolist())

    @staticmethod
    def _embed_rows(req, n: int, rows):
        """Fold one embed chunk's hidden rows (host f32) into the pooling
        accumulators: a running sum for "mean", the newest valid row for
        "last" (rows past ``n`` are bucket padding)."""
        hid = rows[:n]
        s = hid.sum(axis=0)
        req.embed_acc = s if req.embed_acc is None else req.embed_acc + s
        req.embed_last = hid[-1]

    def _ensure_pages(self, slot, req, tokens: int, m) -> bool:
        """Grow ``slot``'s mapping to cover ``tokens`` rows (caller holds
        ``_lock``). Cold cached pages are evicted first; then victims are
        preempted: decoding slots first, most remaining budget first;
        then mid-prefill slots, least progress first. A beam sibling of
        ``req`` is never a victim (its preemption takes the whole group,
        ``slot`` included). If the pool still cannot cover the growth,
        ``req`` itself is preempted (False)."""
        if self._try_map(slot, tokens, m):
            return True
        while True:
            victim_slot = max(
                (i for i, r in enumerate(self.slots)
                 if r is not None and i != slot and r is not req),
                key=lambda i: (self.slots[i].pending is None,
                               -self.slots[i].done_tokens
                               if self.slots[i].pending is not None
                               else self.slots[i].remaining()),
                default=None)
            if victim_slot is None:
                break
            self._preempt_slot(victim_slot, m)
            if self._try_map(slot, tokens, m):
                return True
        self._preempt_slot(slot, m)
        return False

    def _try_map(self, slot, tokens: int, m) -> bool:
        """``PageTable.map``; when the free list cannot cover the growth,
        LRU-evict cached prefix pages (a cold cache goes before a live
        request) and try once more. Caller holds ``_lock``."""
        tokens = int(tokens)
        if self._pages.map(slot, tokens):
            return True
        if self._prefix is not None:
            short = (self._pages.pages_for(tokens)
                     - int(self._pages.mapped[slot])
                     - self._pages.free_pages)
            if short > 0:
                freed = self._prefix.evict(short)
                if freed:
                    m["kv_prefix_evictions"].inc(freed)
                if freed and self._pages.map(slot, tokens):
                    return True
        return False

    def _plan_cow(self, slot, start: int, end: int, m) -> list:
        """Split every page ``slot`` is about to write (context rows
        ``[start, end)``) that has other holders. Caller holds ``_lock``;
        returns the ``(src, dst)`` page copies the caller runs on the
        device (``engine.copy_page``) BEFORE the write — device work
        never runs under the lock. Runs whenever the pool is paged: beam
        lanes share pages without the prefix cache.

        With no free page for a split: evict cold cache, then transfer
        sole ownership (drop the cache's holds on the page — the write is
        then private, no copy), then preempt the other slot mapping it."""
        if not self.paged or end <= start:
            return []
        plen = self._pages.page_len
        copies = []
        for j in range(start // plen, (end - 1) // plen + 1):
            if j >= int(self._pages.mapped[slot]):
                break
            while True:
                p = int(self._pages.table[slot, j])
                if int(self._pages.refcount[p]) <= 1:
                    break                      # private: write in place
                split = self._pages.cow(slot, j)
                if split is not None:
                    copies.append(split)
                    if self._prefix is not None:
                        self._prefix.cow_copies += 1
                    m["kv_cow"].inc()
                    break
                if self._prefix is not None:
                    freed = self._prefix.evict(1)
                    if freed:
                        m["kv_prefix_evictions"].inc(freed)
                        continue
                    if self._prefix.release_page_holds(p):
                        continue               # may now be private
                other = next(
                    (i for i in range(self.n_slots)
                     if i != slot and self.slots[i] is not None
                     and p in self._pages.table[
                         i, :int(self._pages.mapped[i])]),
                    None)
                if other is None:              # refs must come from
                    break                      # somewhere: cannot happen
                self._preempt_slot(other, m)
                if self.slots[slot] is None:
                    # ``other`` was a beam sibling: the group preemption
                    # took this slot too — nothing left to plan
                    return copies
        return copies

    def _first_token(self, slot, req, logits, ctx_tokens: int,
                     prefill_s: float, m, chunks: Optional[int] = None):
        """Shared admission tail: sample the first token (the TTFT
        sample) — through the masked sampler for CONSTRAINED — record the
        trace events, then park the token for the next sweep or finish at
        once. With the prefix cache the just-prefilled context's full
        blocks are registered, so that CONCURRENT requests with the same
        prompt share them from their own admission on."""
        if req.kind is RequestKind.CONSTRAINED:
            mask = workloads.resolve_mask(
                req.token_mask, req.generated,
                int(self.engine.cfg.vocab_size))
            toks = self.engine.sample_masked(
                logits[None], req.temperature, req.top_k, self._gen,
                mask[None])
        else:
            toks = self.engine.sample(logits[None], req.temperature,
                                      req.top_k, self._gen)
        tok = int(self._read_tokens(toks)[0])
        # the TTFT timestamp is taken BEFORE the sampler observation: its
        # cost is booked to trace_overhead, not to the first token
        now = time.perf_counter()
        obs_cost = self._maybe_sample_obs(m, lambda: logits, [req.top_k])
        with self._lock:
            self._trace_overhead += obs_cost
            self.stats["prefills"] += 1
            m["prefills"].inc()
            if req.first_token_ts is None:
                req.first_token_ts = now
                m["ttft"].observe(now - req.submitted_ts)
            if req.trace is not None:
                t_ov = time.perf_counter()
                attrs = {} if chunks is None else {"chunks": chunks}
                req.trace.event("prefill", ts=now, slot=slot,
                                tokens=ctx_tokens, time_s=prefill_s,
                                **attrs)
                req.trace.event("token", ts=now, i=len(req.generated))
                self._trace_cost(t_ov)
            if self.paged and self._prefix is not None:
                ctx_now = req.context()
                self._pages.note_fill(slot, ctx_now.size)
                self._prefix.insert(ctx_now, self._pages.slot_pages(slot))
            req.generated.append(tok)
            self.stats["tokens"] += 1
            m["tokens"].inc()
            m["wl_tokens"].inc(kind=req.kind.value)
            if self._done(req, tok):
                self.slots[slot] = None
                released = self._retire_slot(slot, req)
                self._finish(req, tok, m, mapped_pages=released)
            else:
                self._last_tokens[slot] = tok

    def _trace_cost(self, t0: float, carved: float = 0.0) -> None:
        """Book the trace bookkeeping since ``t0`` to trace_overhead,
        and to the plane's ``trace`` share less what ``carved`` already
        booked to another share (caller holds ``_lock``)."""
        dt = time.perf_counter() - t0
        self._trace_overhead += dt
        self._plane_s["trace"] += dt - carved

    def _span(self, name: str, attrs) -> "_DispatchSpan":
        """A span around one dispatch (:class:`_DispatchSpan`)."""
        return _DispatchSpan(self._plane_s, name, attrs)

    def _maybe_sample_obs(self, m, rows_fn, topks) -> float:
        """Shared sampler-observation cadence for admissions and sweeps
        (one counter, one modulo): returns the self-timed cost to add to
        trace_overhead. ``rows_fn`` defers reading the logits until the
        cadence says observe."""
        if not self.sample_obs_every:
            return 0.0
        self._obs_events += 1
        if self._obs_events % self.sample_obs_every:
            return 0.0
        t_obs = time.perf_counter()
        try:
            self._sample_obs(m, rows_fn(), topks)
        except Exception:  # noqa: BLE001 — observability must never
            pass           # perturb the admission or sweep
        dt = time.perf_counter() - t_obs
        self._plane_s["sampler"] += dt
        return dt

    @staticmethod
    def _sample_obs(m, logits_rows, topks):
        """Sampler observability: the mean next-token entropy over the
        given logit rows, and the mean probability mass the top-k filter
        keeps over the rows with top_k > 0 — the reference's host formula
        (softmax at temperature 1 in f32, ``-sum p log(p + 1e-30)``, the
        k largest probabilities summed), reduced where the logits are: on
        the card two floats come back, never the (rows, V) logits."""
        lg = logits_rows.detach()
        if lg.dim() == 1:
            lg = lg[None]
        if lg.numel() == 0:
            return
        p = torch.softmax(lg, dim=-1, dtype=torch.float32)
        # -p log p, 0 at p = 0: the host formula's -p log(p + 1e-30) to
        # within V * 1e-30 * 69 nats
        ent = torch.special.entr(p).sum(dim=-1).mean()
        ks = [min(int(k), lg.shape[-1]) for k in topks]
        rows = [i for i, k in enumerate(ks) if k > 0]
        if not rows:
            m["sample_entropy"].observe(float(ent))
            return
        kk = torch.as_tensor([ks[i] for i in rows], device=lg.device)
        top = torch.topk(p[rows], max(ks[i] for i in rows), dim=-1).values
        keep = torch.arange(top.shape[-1], device=lg.device) < kk[:, None]
        mass = (top * keep).sum() / len(rows)
        ent_v, mass_v = torch.stack([ent, mass]).tolist()
        m["sample_entropy"].observe(ent_v)
        m["topk_mass"].observe(mass_v)

    def _decode_sweep(self, m) -> bool:
        with self._lock:      # snapshot; only step() (serialized) mutates
            cows = []
            if self.paged:
                # a page is shared only under the prefix cache's holds or
                # when two mappings name it (beam lanes); growth below
                # maps fresh pages, so a pool with neither has no split
                # to plan this sweep
                shared = self._prefix is not None or \
                    self._pages.mapped_pages != self._pages.used_pages
                # page growth BEFORE the sweep: each decoding slot's next
                # write position must be mapped; under pressure
                # _ensure_pages preempts, so re-derive the active set
                for i in range(self.n_slots):
                    req = self.slots[i]
                    if req is None or req.pending is not None:
                        continue
                    w = self._slot_tokens(req)
                    ok = self._ensure_pages(i, req, w, m)
                    if shared and ok and self.slots[i] is req:
                        # the sweep writes this slot's row w-1: split it
                        # first if shared (a session's append, beam
                        # siblings on one tail page)
                        cows.extend(self._plan_cow(i, w - 1, w, m))
            active = [i for i, r in enumerate(self.slots)
                      if r is not None and r.pending is None]
            if not active:
                return False
            vocab = int(self.engine.cfg.vocab_size)
            temps = np.zeros((self.n_slots,), np.float32)
            topks = np.zeros((self.n_slots,), np.int64)
            masks = None
            for i in active:
                temps[i] = self.slots[i].temperature
                topks[i] = self.slots[i].top_k
                if self.slots[i].kind is RequestKind.CONSTRAINED:
                    # the mask for the NEXT token; other lanes stay
                    # all-true (their tokens are the plain sampler's)
                    if masks is None:
                        masks = np.ones((self.n_slots, vocab), bool)
                    masks[i] = workloads.resolve_mask(
                        self.slots[i].token_mask,
                        self.slots[i].generated, vocab)
            active_kinds = [self.slots[i].kind._value_ for i in active]
            tokens_in = self._last_tokens.copy()
        if self.paged:
            for src, dst in cows:
                self.cache = self.engine.copy_page(self.cache, src, dst)
            self._pages.sync(self.cache)
        n = len(active)
        ch = self._ch
        t0 = time.perf_counter()
        with self._span("serving.decode", {"active": n}) as dspan:
            logits, self.cache = self.engine.decode_step(self.cache,
                                                         tokens_in)
            if masks is None:
                toks = self.engine.sample(logits, temps, topks, self._gen)
            else:
                toks = self.engine.sample_masked(logits, temps, topks,
                                                 self._gen, masks)
            # what needs no token, while the card runs the sweep: the
            # span's record and the registry's writes
            dspan.build()
            t_reg = time.perf_counter()
            m["decode_steps"].inc()
            ch["occupancy"].set(n / self.n_slots)
            m["tokens"].inc(n)
            for kv in set(active_kinds):
                self._ch_tokens[kv].inc(active_kinds.count(kv))
            self._plane_s["registry"] += time.perf_counter() - t_reg
            toks = self._read_tokens(toks)
        dt = time.perf_counter() - t0
        t_reg = time.perf_counter()
        m["decode_s"].observe(dt)
        if dt > 0:
            ch["tokens_per_s"].set(n / dt)
        # the token timestamp BEFORE the sampler observation: its cost is
        # booked to trace_overhead and must not skew the ITL samples
        tok_ts = time.perf_counter()
        self._plane_s["registry"] += tok_ts - t_reg
        obs_cost = self._maybe_sample_obs(
            m, lambda: logits if n == self.n_slots else logits[active],
            [topks[i] for i in active])
        with self._lock:
            self.stats["decode_steps"] += 1
            self.stats["decode_s"] += dt
            self.stats["decode_tokens"] += n
            self.stats["tokens"] += n
            # trace bookkeeping first (self-timed): one token timestamp a
            # sweep — the pool's tokens land together
            self._trace_overhead += obs_cost
            t_ov = time.perf_counter()
            for i in active:
                req = self.slots[i]
                if req is not None and req.beam is None \
                        and req.trace is not None:
                    # RequestTrace.event's record, appended directly
                    req.trace.events.append(
                        ("token", tok_ts, {"i": len(req.generated)}))
            self._trace_cost(t_ov)
            beams = []
            for i in active:
                req = self.slots[i]
                if req is None:
                    continue
                if req.beam is not None:
                    # one joint step a GROUP, below
                    if all(b is not req for b in beams):
                        beams.append(req)
                    continue
                tok = int(toks[i])
                req.generated.append(tok)
                self._last_tokens[i] = tok
                if self._done(req, tok):
                    self.slots[i] = None
                    released = self._retire_slot(i, req)
                    self._finish(req, tok, m, mapped_pages=released)
            if beams:
                # only a sweep with a live beam group reads the logits
                logits_np = _host(logits)
                for req in beams:
                    self._advance_beam(req, logits_np, m, tok_ts)
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
        prefilling, prompt + generated when decoding (a beam group's
        lockstep progress on its lanes)."""
        if r.pending is not None:
            return r.done_tokens
        if r.beam is not None:
            return r.prompt.size + r.beam.progress()
        return r.prompt.size + len(r.generated)

    # ------------------------------------------------------ beam search
    def _expand_beam(self, root: int, req: ServingRequest, logits,
                     ctx_tokens: int, prefill_s: float, m):
        """Fan the finished root prefill out into the beam group: rank
        the root's next-token log-probs (host f32, numpy's stable sort),
        give the top candidates one reserved lane each — the root keeps
        its lane, every sibling ``map_shared``s the root's pages, so the
        prefix costs ONE set of pages and divergence splits lazily in the
        sweep's copy-on-write pass. This is the TTFT sample. A candidate
        that is terminal on arrival (instant EOS, budget 1) goes straight
        to the done list and frees its lane."""
        lg = _host(logits)
        lg = lg - lg.max()
        lsm = lg - np.log(np.exp(lg).sum())
        now = time.perf_counter()
        pos_fix = []
        m["prefills"].inc()
        with self._lock:
            self.stats["prefills"] += 1
            beam = req.beam
            if beam is None or self.slots[root] is not req:
                return          # group preempted since the last chunk
            if req.first_token_ts is None:
                req.first_token_ts = now
                m["ttft"].observe(now - req.submitted_ts)
            if req.trace is not None:
                t_ov = time.perf_counter()
                req.trace.event("prefill", ts=now, slot=root,
                                tokens=ctx_tokens, time_s=prefill_s,
                                chunks=req.chunks)
                req.trace.event("token", ts=now, i=0)
                self._trace_cost(t_ov)
            lanes = list(beam.slots)
            order = np.argsort(-lsm, kind="stable")[:len(lanes)]
            root_pages = self._pages.slot_pages(root)
            self._pages.note_fill(root, ctx_tokens)
            alive_slots: List[int] = []
            alive_tokens: List[List[int]] = []
            alive_scores: List[float] = []
            root_done = False
            for rank, t in enumerate(order):
                t, sc = int(t), float(lsm[int(t)])
                slot = lanes[rank]
                finished = ((req.eos_id is not None and t == req.eos_id)
                            or req.max_new_tokens <= 1)
                if rank > 0 and not finished:
                    # the fan-out itself costs no new page
                    self._pages.map_shared(slot, root_pages)
                    self._pages.note_fill(slot, ctx_tokens)
                    pos_fix.append(slot)
                if finished:
                    beam.done.append(([t], sc))
                    if rank == 0:
                        root_done = True    # release AFTER clones map
                    else:
                        self.slots[slot] = None
                else:
                    alive_slots.append(slot)
                    alive_tokens.append([t])
                    alive_scores.append(sc)
                    self._last_tokens[slot] = t
            for slot in lanes[len(order):]:   # vocab < width leftovers
                self.slots[slot] = None
            if root_done:
                req.released_pages += self._pages.release(root)
                self.slots[root] = None
            beam.slots, beam.tokens, beam.scores = \
                alive_slots, alive_tokens, alive_scores
            beam.expanded = True
            self.stats["tokens"] += len(order)
            m["tokens"].inc(len(order))
            m["wl_tokens"].inc(len(order), kind=req.kind.value)
            if not alive_slots:
                self._finish_beam(req, m)
        if pos_fix:
            # sibling lanes were never prefilled: their cursors start at
            # the shared context's length (in place, before the sweep)
            self.cache = self.engine.set_positions(self.cache, pos_fix,
                                                   ctx_tokens)

    def _advance_beam(self, req: ServingRequest, logits_np, m, tok_ts):
        """One joint beam step after the sweep (caller holds ``_lock``):
        rank score + logprob over every (live beam, token) pair with
        numpy's stable sort, keep the top ``len(slots)``, and re-point
        the lanes — a parent's FIRST surviving candidate keeps the
        parent's lane (and pages) in place; every further candidate of
        the same parent maps a freed lane onto the parent's pages
        (``map_shared``; the next sweep's copy-on-write pass splits the
        written tail page). Finished candidates retire to the done list
        and shrink the width. At width 1 the candidate is the argmax of
        the logits: greedy ``generate``'s token."""
        beam = req.beam
        if beam is None or not beam.slots:
            return
        lanes = list(beam.slots)
        ka = len(lanes)
        lg = logits_np[np.asarray(lanes)]
        lg = lg - lg.max(axis=-1, keepdims=True)
        lsm = lg - np.log(np.exp(lg).sum(axis=-1, keepdims=True))
        vocab = lsm.shape[-1]
        cand = np.asarray(beam.scores, np.float64)[:, None] + lsm
        order = np.argsort(-cand, axis=None, kind="stable")[:ka]
        parents = (order // vocab).astype(int)
        toks = (order % vocab).astype(int)
        if req.trace is not None:
            t_ov = time.perf_counter()
            req.trace.event("token", ts=tok_ts, i=beam.progress())
            self._trace_cost(t_ov)
        written = req.prompt.size + len(beam.tokens[0])
        # page lists taken BEFORE any release: a clone increfs its
        # parent's pages from this list
        parent_pages = {int(p): self._pages.slot_pages(lanes[int(p)])
                        for p in set(parents.tolist())}
        chosen = set(parents.tolist())
        # lanes of parents with NO surviving candidate free first (no
        # clone maps FROM them); a chosen parent's pages are released
        # only after every clone has taken its refs
        free_lanes = [lanes[p] for p in range(ka) if p not in chosen]
        for s in free_lanes:
            req.released_pages += self._pages.release(s)
        alive_slots: List[int] = []
        alive_tokens: List[List[int]] = []
        alive_scores: List[float] = []
        deferred: List[int] = []
        first_seen: set = set()
        for r in range(len(order)):
            p, t = int(parents[r]), int(toks[r])
            sc = float(cand[p, t])
            seq = beam.tokens[p] + [t]
            finished = ((req.eos_id is not None and t == req.eos_id)
                        or len(seq) >= req.max_new_tokens)
            keeps_lane = p not in first_seen
            first_seen.add(p)
            if finished:
                beam.done.append((seq, sc))
                if keeps_lane:
                    deferred.append(lanes[p])
                continue
            if keeps_lane:
                slot = lanes[p]
            else:
                slot = free_lanes.pop()
                self._pages.map_shared(slot, parent_pages[p])
                self._pages.note_fill(slot, written)
                self.slots[slot] = req
            self._last_tokens[slot] = t
            alive_slots.append(slot)
            alive_tokens.append(seq)
            alive_scores.append(sc)
        for s in deferred:
            # parents whose lane-keeping candidate finished: release only
            # now — later clones of the same parent hold their refs
            req.released_pages += self._pages.release(s)
            self.slots[s] = None
        for s in free_lanes:    # unselected lanes no clone claimed
            self.slots[s] = None
        beam.slots, beam.tokens, beam.scores = \
            alive_slots, alive_tokens, alive_scores
        if not alive_slots:
            self._finish_beam(req, m)

    # -------------------------------------------------- typed finishes
    def _finish_prefill_only(self, slot: int, req: ServingRequest, m):
        """SCORE and EMBED retire at their final prefill chunk and never
        take decode-sweep time. The completion instant is also the
        first-token instant (the prefill is the product), and the
        per-kind token counter books the prompt."""
        m["prefills"].inc()
        now = time.perf_counter()
        with self._lock:
            self.stats["prefills"] += 1
            if self.slots[slot] is not req:
                return          # preempted between chunk and finish
            if req.first_token_ts is None:
                req.first_token_ts = now
                m["ttft"].observe(now - req.submitted_ts)
            if req.trace is not None:
                t_ov = time.perf_counter()
                req.trace.event("prefill", ts=now, slot=slot,
                                tokens=int(req.prompt.size),
                                time_s=req.prefill_s, chunks=req.chunks)
                req.trace.event("token", ts=now, i=0)
                self._trace_cost(t_ov)
            self.slots[slot] = None
            released = self._release_pages(slot)
            n_tok = int(req.prompt.size)
            if req.kind is RequestKind.SCORE:
                lps = np.asarray(req.score_lps, np.float32)
                ppl = (float(np.exp(-lps.mean())) if lps.size
                       else float("inf"))
                result = ScoreResult(logprobs=lps, perplexity=ppl,
                                     prompt_tokens=n_tok)
            else:
                emb = (req.embed_last if req.pooling == "last"
                       else req.embed_acc / float(n_tok))
                result = EmbedResult(
                    embedding=np.asarray(emb, np.float32),
                    pooling=req.pooling, prompt_tokens=n_tok)
            m["wl_tokens"].inc(n_tok, kind=req.kind.value)
            self._finish_workload(req, result, "complete", m, released,
                                  n_tok)

    def _finish_beam(self, req: ServingRequest, m):
        """All hypotheses done (caller holds ``_lock``; lanes and pages
        were released as each finished): resolve the future with the
        :class:`BeamResult`, best first."""
        done = req.beam.done
        order = sorted(range(len(done)), key=lambda i: -done[i][1])
        seqs = [np.asarray(done[i][0], np.int32) for i in order]
        scores = [float(done[i][1]) for i in order]
        reason = ("eos" if (req.eos_id is not None and seqs
                            and seqs[0].size
                            and int(seqs[0][-1]) == req.eos_id)
                  else "length")
        result = BeamResult(sequences=seqs, scores=scores,
                            beam_width=req.beam_width,
                            finish_reason=reason)
        resident = req.prompt.size + (seqs[0].size if seqs else 0)
        self._finish_workload(req, result, reason, m, req.released_pages,
                              resident)

    def _finish_workload(self, req: ServingRequest, result, reason, m,
                         mapped_pages: int, resident: int):
        """Completion tail of the typed results (SCORE, EMBED, BEAM):
        timings, residency accounting, the trace's close-out and the
        future — ``_finish``'s discipline with the result swapped."""
        now = time.perf_counter()
        self.stats["completions"] += 1
        m["completions"].inc(reason=reason)
        m["wl_completions"].inc(kind=req.kind.value)
        m["latency"].observe(now - req.submitted_ts)
        result.latency_s = now - req.submitted_ts
        result.ttft_s = (None if req.first_token_ts is None
                         else req.first_token_ts - req.submitted_ts)
        result.prefill_s = req.prefill_s
        t_ov = time.perf_counter()
        ratio = self._note_final_residency(resident, mapped_pages, m)
        carved = self._close_trace(
            req, "finish", m, reason=reason,
            resident_tokens=min(int(resident), self.engine.max_len),
            residency_ratio=round(ratio, 6))
        self._trace_cost(t_ov, carved)
        try:
            req.future.set_result(result)
        except InvalidStateError:
            pass   # the caller gave up on an in-flight request

    def _finish(self, req: ServingRequest, last_tok: int, m,
                mapped_pages: int = 0):
        reason = "eos" if (req.eos_id is not None
                           and last_tok == req.eos_id) else "length"
        now = time.perf_counter()
        self.stats["completions"] += 1
        m["completions"].inc(reason=reason)
        m["wl_completions"].inc(kind=req.kind.value)
        m["latency"].observe(now - req.submitted_ts)
        t_ov = time.perf_counter()
        resident = req.prompt.size + len(req.generated)
        ratio = self._note_final_residency(resident, mapped_pages, m)
        carved = self._close_trace(
            req, "finish", m, reason=reason,
            resident_tokens=min(int(resident), self.engine.max_len),
            residency_ratio=round(ratio, 6))
        self._trace_cost(t_ov, carved)
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

    # ------------------------------------------------ KV accounting
    def _note_final_residency(self, resident: int, mapped_pages: int,
                              m) -> float:
        """A finished request's final residency: how much of what it
        reserved it used — the max_len slot under dense slotting, its
        mapped pages under paging. Returns the ratio."""
        resident = min(int(resident), self.engine.max_len)
        if self.paged:
            cap = max(1, mapped_pages) * self._pages.page_len
            ratio = min(1.0, resident / cap)
        else:
            ratio = resident / self.engine.max_len
        m["kv_final"].observe(ratio)
        self._final_res_sum += ratio
        self._final_res_n += 1
        return ratio

    def _close_trace(self, req: ServingRequest, kind: str, m,
                     **attrs) -> float:
        """Terminal trace bookkeeping for one request: the terminal
        event, its ITL samples into the histogram, the black-box record,
        SLO accounting and the span tree. Returns the seconds booked to
        the plane's ``slo`` and ``spans`` shares."""
        tr = req.trace
        if tr is None:
            return 0.0
        tr.event(kind, **attrs)
        summary = tr.summary()    # computed once: histogram + SLO share
        m["itl"].observe_many(summary["itl_s"])
        self.flight_recorder.record_request(tr)
        carved = 0.0
        if self.slo is not None:
            t0 = time.perf_counter()
            self.slo.observe_summary(summary)
            dt = time.perf_counter() - t0
            self._plane_s["slo"] += dt
            carved += dt
        if self.trace_spans:
            t0 = time.perf_counter()
            tr.assemble_spans()
            dt = time.perf_counter() - t0
            self._plane_s["spans"] += dt
            carved += dt
        return carved

    def _record_snapshot(self, m):
        """One flight-recorder snapshot of a working step (under
        ``_step_lock``), carrying the KV residency accounting, so that
        the flight recorder is also the memory timeline. The accumulators
        update under ``_lock`` (the lock ``kv_report`` and
        ``reset_kv_window`` take). One pass over the slots gives the ids,
        the active count, the per-kind census (a beam group's lanes count
        its request once) and the resident tokens. With the prefix cache
        a shared page counts ONCE: allocated = pool pages with a holder
        (slots or cache), resident = the per-page fill census, refreshed
        here for the active slots."""
        with self._lock:
            queued_ids = [r.id for r in self._queue]
            max_len = self.engine.max_len
            slot_ids: list = []
            kinds: dict = {}
            seen_ids: set = set()
            resident_tokens = 0
            n_active = 0
            for r in self.slots:
                if r is None:
                    slot_ids.append(None)
                    continue
                rid = r.id
                slot_ids.append(rid)
                n_active += 1
                if rid not in seen_ids:
                    seen_ids.add(rid)
                    # the member's plain value: Enum's .value and hash
                    # run Python code, too slow for every slot of a step
                    k = r.kind._value_
                    kinds[k] = kinds.get(k, 0) + 1
                # _slot_tokens, inlined: this runs every step
                if r.pending is not None:
                    t = r.done_tokens
                elif r.beam is not None:
                    t = r.prompt.size + r.beam.progress()
                else:
                    t = r.prompt.size + len(r.generated)
                resident_tokens += t if t < max_len else max_len
            resident = resident_tokens * self._kv_token_bytes
            if n_active > self._peak_active:
                self._peak_active = n_active
            if self.paged and self._prefix is not None:
                for i, r in enumerate(self.slots):
                    if r is not None:
                        self._pages.note_fill(
                            i, self._slot_tokens(r)
                            - (0 if r.pending is not None else 1))
                alloc = self._pages.used_pages * self._kv_page_bytes
                mapped = self._pages.mapped_pages
                resident = min(self._pages.resident_tokens
                               * self._kv_token_bytes, alloc)
            elif self.paged:
                # a just-sampled token counts resident one sweep before
                # its page is mapped: clamp
                mapped = self._pages.mapped_pages
                alloc = mapped * self._kv_page_bytes
                resident = min(resident, alloc)
            else:
                alloc = self._kv_allocated
                mapped = None
            waste = (1.0 - resident / alloc) if alloc else 0.0
            self._kv_last_resident = resident
            self._kv_last_alloc = alloc
            self._kv_resident_sum += resident
            self._kv_alloc_sum += alloc
            self._kv_samples += 1
        ch = self._ch
        if alloc != self._kv_pub_alloc:
            # the dense pool's allocation is static: written once
            self._kv_pub_alloc = alloc
            ch["kv_alloc"].set(float(alloc))
        ch["kv_res"].set(float(resident))
        ch["kv_waste"].set(waste)
        if kinds != self._kinds_last:
            self._kinds_last = kinds
            for kv in workloads.ALL_KINDS:
                # an idle kind reads 0, not a frozen last-busy value; only
                # a CHANGED count pays a gauge write
                n_kind = kinds.get(kv, 0)
                if self._kind_census_pub.get(kv) != n_kind:
                    self._kind_census_pub[kv] = n_kind
                    self._ch_active[kv].set(float(n_kind))
        self._steps += 1
        paged_fields = {} if not self.paged else {
            "kv_mapped_pages": mapped,
            "kv_page_len": self._pages.page_len,
            "kv_pool_bytes": self._kv_allocated,
        }
        if self._prefix is not None:
            # the sharing census on every snapshot
            shared = self._pages.shared_pages
            cached = self._prefix.cached_pages
            paged_fields.update(
                kv_used_pages=self._pages.used_pages,
                kv_shared_pages=shared,
                kv_cached_pages=cached,
                kv_cow_copies_total=self._prefix.cow_copies,
                kv_prefix_hits_total=self._prefix.hits,
                kv_prefix_hit_tokens_total=self._prefix.hit_tokens,
            )
            ch["kv_shared"].set(float(shared))
            ch["kv_cached"].set(float(cached))
        self.flight_recorder.record_snapshot(
            step=self._steps, slots=slot_ids, queue=queued_ids,
            queue_depth=len(queued_ids),
            request_kinds=kinds,
            occupancy=n_active / self.n_slots,
            kv_allocated_bytes=alloc,
            kv_resident_bytes=resident,
            kv_token_bytes=self._kv_token_bytes,
            kv_waste_ratio=round(waste, 6),
            **paged_fields)

    def _record_idle(self):
        """An idle step: the occupancy and throughput gauges drop to 0
        (not frozen at their last busy value), and residency drains — a
        dense idle pool is all waste, a paged one maps nothing except
        what the prefix cache still holds (real pool bytes until
        evicted)."""
        ch = self._ch
        ch["occupancy"].set(0.0)
        ch["tokens_per_s"].set(0.0)
        if self.paged and self._prefix is not None:
            with self._lock:
                alloc = self._pages.used_pages * self._kv_page_bytes
                resident = min(alloc, self._pages.resident_tokens
                               * self._kv_token_bytes)
                self._kv_last_resident = resident
                self._kv_last_alloc = alloc
                self._kv_pub_alloc = alloc
            ch["kv_alloc"].set(float(alloc))
            ch["kv_res"].set(float(resident))
            ch["kv_waste"].set((1.0 - resident / alloc) if alloc else 0.0)
            ch["kv_cached"].set(float(self._prefix.cached_pages))
            ch["kv_shared"].set(float(self._pages.shared_pages))
            return
        ch["kv_res"].set(0.0)
        if self.paged:
            ch["kv_alloc"].set(0.0)
            ch["kv_waste"].set(0.0)
        else:
            ch["kv_waste"].set(1.0)
        with self._lock:
            self._kv_last_resident = 0
            if self.paged:
                self._kv_last_alloc = 0
                self._kv_pub_alloc = 0

    def _debug_extra(self):
        """Live state merged into ``flight_recorder.debug_state()``."""
        with self._lock:
            state = {
                "n_slots": self.n_slots,
                "occupancy": sum(r is not None for r in self.slots)
                / self.n_slots,
                "queue_depth": len(self._queue),
                "slots": [None if r is None else r.id
                          for r in self.slots],
                "steps": self._steps,
                "trace_overhead_seconds": round(self._trace_overhead, 6),
            }
        state["kv"] = self.kv_report()
        state["compiles"] = self.engine.compile_report()
        if self.slo is not None:
            state["slo"] = self.slo.report()
        return state

    # ---------------------------------------------------- inspection
    @property
    def trace_overhead_seconds(self) -> float:
        """Cumulative host cost of the plane's bookkeeping (trace events,
        snapshots, trace close-out, sampler observations), self-timed."""
        return self._trace_overhead

    def queue_depth(self) -> int:
        with self._lock:
            return len(self._queue)

    def reset_kv_window(self):
        """Restart the KV residency accumulators (running means and
        final-residency samples), e.g. after a warm-up."""
        with self._lock:
            self._kv_resident_sum = 0.0
            self._kv_alloc_sum = 0.0
            self._kv_samples = 0
            self._final_res_sum = 0.0
            self._final_res_n = 0
            self._peak_active = 0
        return self

    def kv_report(self) -> dict:
        """KV residency accounting, plain data: allocated vs resident
        bytes, the running-mean waste ratio since construction (or the
        last ``reset_kv_window``), per-token bytes, mean final residency;
        ``"paged"`` the page census, ``"prefix"`` the prefix cache's
        counters (hits, hit tokens, copy-on-write copies, evictions)."""
        with self._lock:
            mean_res = (self._kv_resident_sum / self._kv_samples
                        if self._kv_samples else 0.0)
            if self.paged:
                alloc_last = self._kv_last_alloc
                mean_alloc = (self._kv_alloc_sum / self._kv_samples
                              if self._kv_samples else 0.0)
                waste_mean = (1.0 - self._kv_resident_sum
                              / self._kv_alloc_sum
                              if self._kv_alloc_sum else 0.0)
            else:
                alloc_last = mean_alloc = self._kv_allocated
                waste_mean = (1.0 - mean_res / self._kv_allocated
                              if self._kv_allocated else 0.0)
            out = {
                "allocated_bytes": alloc_last,
                "allocated_bytes_mean": round(mean_alloc, 1),
                "pool_bytes": self._kv_allocated,
                "token_bytes": self._kv_token_bytes,
                "resident_bytes_last": self._kv_last_resident,
                "resident_bytes_mean": round(mean_res, 1),
                "waste_ratio_last": round(1.0 - self._kv_last_resident
                                          / alloc_last, 6) if alloc_last
                else 0.0,
                "waste_ratio_mean": round(waste_mean, 6),
                "snapshots": self._kv_samples,
                "peak_concurrent": self._peak_active,
                "final_residency_mean": round(
                    self._final_res_sum / self._final_res_n, 6)
                if self._final_res_n else None,
                "finished_requests": self._final_res_n,
            }
            if self.paged:
                out["paged"] = self._pages.report()
                out["kv_dtype"] = str(self.cache["k"].dtype).replace(
                    "torch.", "")
            if self._prefix is not None:
                out["prefix"] = self._prefix.report()
            return out

    def drop_session(self, session_id: str) -> bool:
        """Release a session's retained pages (end of the conversation):
        they stay as cached prefix pages if the block index holds them,
        else they free. True if the session existed."""
        with self._lock:
            if self._prefix is None:
                return False
            return self._prefix.drop_session(session_id)

    def check_pages(self) -> bool:
        """Assert the free-XOR-refcounted page invariant, with the prefix
        cache's holds as the external refs. True for dense pools."""
        with self._lock:
            if not self.paged:
                return True
            return self._pages.check(
                self._prefix.holds() if self._prefix is not None
                else None)


class _DispatchSpan:
    """A ``serving.*`` span around one dispatch (the reference's
    ``with span(...)``; nothing nests inside one, so it never becomes the
    current span). Entering costs two clock reads; the span's ids and
    record are made by :meth:`build` — on the decode sweep while the card
    computes it — or at exit, and it is recorded at exit. Its own cost is
    self-timed into the plane's ``spans`` share."""
    __slots__ = ("plane", "name", "attrs", "start_ts", "t0", "sp")

    def __init__(self, plane, name, attrs):
        self.plane, self.name, self.attrs, self.sp = plane, name, attrs, None

    def __enter__(self):
        self.start_ts = time.time()
        self.t0 = time.perf_counter()
        return self

    def build(self):
        if self.sp is None:
            t = time.perf_counter()
            self.sp = get_tracer().new_span(self.name, self.attrs)
            self.plane["spans"] += time.perf_counter() - t

    def __exit__(self, *exc):
        t_end = time.perf_counter()
        self.build()
        sp = self.sp
        sp.start_ts, sp.time_s = self.start_ts, t_end - self.t0
        get_tracer().add_span(sp)
        self.plane["spans"] += time.perf_counter() - t_end
        return False


def _host(t: torch.Tensor) -> np.ndarray:
    """A device tensor's values as host f32 numpy."""
    return t.detach().float().cpu().numpy()
