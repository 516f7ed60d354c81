"""Fleet serving fabric: replicated engines behind a leased router with
SLO-driven autoscaling. Port of ``deeplearning4j_tpu/serving/fleet.py``:
the same routing, leases, wire frames, autoscaler, metrics and black box.

The tier above the continuous-batching scheduler: a :class:`FleetRouter`
fronts N scheduler-wrapped :class:`~.engine.GenerationEngine` replicas.
Replica handles are in-process today, but every submit and every result
round-trips the ``parallel/transport.py`` fleet frames
(``KIND_FLEET_SUBMIT`` / ``KIND_FLEET_RESULT``), so the byte layout that
a socket-backed replica host needs is exercised by every request.

Requests become leased work items on a
:class:`~..parallel.leases.RequestLeaseTable` — the serving sibling of
the training lease table, carrying over its exactly-once completion
contract unchanged:

- every caller future resolves exactly once, fed by whichever replica
  currently HOLDS the item's lease;
- a replica death mid-decode releases its leases and the router
  re-prefills each on a survivor (recompute, the same mechanism as
  scheduler preemption — greedy output is bit-identical to the
  single-engine oracle because prefill reproduces the interrupted
  decode's logits exactly);
- a ghost result from a presumed-dead replica whose lease was re-granted
  fails ``complete()`` and is dropped (``dl4j_fleet_ghost_results_total``).

Routing prefers AFFINITY — a ``session_id`` or a shared
prompt prefix lands on the replica already holding those KV pages — and
falls back to least burn-rate (each replica's rolling
``dl4j_slo_burn_rate``), tie-broken by load. The :class:`Autoscaler`
closes the control loop: sustained burn above target (or deep queues)
spawns a replica, sustained calm drains one via the scheduler's
``drain()`` — in-flight requests finish, unstarted queue entries are
handed back and re-routed, no future fails.

On the card a replica's scheduler owns its KV pool, and a graph bakes the
addresses of the pool it was captured on, so each replica compiles its
own signatures (eager, then capture) — a replica the autoscaler spawns
under traffic compiles under traffic. A replica that dies or retires
releases its pool (``ContinuousBatchingScheduler.release``), and its
graphs go with it; it stays in ``router.replicas`` with only its flight
recorder, for ``dump()``. The router's ``submit`` and the lease table
touch no device tensor.

The whole episode is black-boxed: a fleet-level
:class:`~..obs.FlightRecorder` (``replica="fleet"``) snapshots
live/target replica counts, burn and scale events, and ``dump()``
appends it plus every replica's recorder (live, dead and retired) into
ONE JSONL that ``scripts/slo_report.py --fleet`` replays into a
per-replica + fleet-total goodput table.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np

from ..obs import FlightRecorder, SLOConfig, SLOTracker, get_registry
from ..parallel.leases import RequestLeaseTable
from ..parallel.transport import (KIND_FLEET_RESULT, KIND_FLEET_SUBMIT,
                                  pack_fleet_result, pack_fleet_submit,
                                  unpack_fleet_result, unpack_fleet_submit)
from . import workloads
from .engine import GenerationEngine
from .scheduler import ContinuousBatchingScheduler
from .workloads import (BeamResult, EmbedResult, RequestKind, ScoreResult,
                        WIRE_POOLING)


@dataclass
class FleetResult:
    """What a fleet caller's future resolves to. The typed request
    plane rides the same frame for every kind — ``kind``
    says which of the per-kind payload fields is populated:
    ``logprobs`` (SCORE, the per-token logprob vector), ``embedding``
    (EMBED, the pooled hidden state) or ``best_logprob`` (BEAM, the
    winning hypothesis' total logprob — its ids are ``tokens``)."""
    tokens: np.ndarray          # generated ids, prompt excluded
    finish_reason: str          # "eos" | "length" | "complete"
    item: int                   # lease item id
    replica: str                # label of the replica that COMPLETED it
    reprefills: int             # times the lease moved (replica deaths)
    ttft_s: Optional[float]
    latency_s: float
    kind: str = "generate"      # RequestKind value string
    logprobs: Optional[np.ndarray] = None       # SCORE
    embedding: Optional[np.ndarray] = None      # EMBED
    best_logprob: Optional[float] = None        # BEAM


@dataclass(frozen=True)
class AutoscalerConfig:
    """SLO-driven scaling policy. Burn rate is the primary signal
    (sustained >1 means the quantile objective WILL be missed); queue
    depth per replica is the leading indicator that trips before a
    slow rolling window does."""
    min_replicas: int = 1
    max_replicas: int = 4
    high_burn: float = 1.0       # sustained above → pressure
    low_burn: float = 0.5        # below this (and queues calm) → calm
    high_queue: float = 4.0      # queued requests per replica → pressure
    patience: int = 3            # consecutive evals before acting
    cooldown: int = 4            # evals to hold after a scale event

    def __post_init__(self):
        if self.min_replicas < 1 or self.max_replicas < self.min_replicas:
            raise ValueError("need 1 <= min_replicas <= max_replicas")
        if self.patience < 1:
            raise ValueError("patience must be >= 1")


class Autoscaler:
    """Hysteresis over the burn/queue signals: ``evaluate`` returns
    +1 (spawn), -1 (retire) or 0. Pure host-side state machine — the
    synthetic-burn unit tests drive it directly."""

    def __init__(self, config: Optional[AutoscalerConfig] = None):
        self.config = config or AutoscalerConfig()
        self._high = 0
        self._low = 0
        self._hold = 0
        self.events: List[str] = []     # "up"/"down" history

    def evaluate(self, burn: Optional[float], queue_per_replica: float,
                 n_live: int) -> int:
        cfg = self.config
        b = 0.0 if burn is None else float(burn)
        pressured = b > cfg.high_burn or queue_per_replica > cfg.high_queue
        calm = b < cfg.low_burn and queue_per_replica <= 1.0
        if pressured:
            self._high += 1
            self._low = 0
        elif calm:
            self._low += 1
            self._high = 0
        else:
            self._high = 0
            self._low = 0
        if self._hold > 0:
            self._hold -= 1
            return 0
        if self._high >= cfg.patience and n_live < cfg.max_replicas:
            self._high = 0
            self._hold = cfg.cooldown
            self.events.append("up")
            return 1
        if self._low >= cfg.patience and n_live > cfg.min_replicas:
            self._low = 0
            self._hold = cfg.cooldown
            self.events.append("down")
            return -1
        return 0


class InProcessReplica:
    """One scheduler-wrapped engine behind the fleet wire boundary.

    ``submit_frame`` takes a packed ``KIND_FLEET_SUBMIT`` payload and
    unpacks it replica-side — the router never hands this class a
    Python object a socket could not carry, so a host process speaking
    the same frames can replace it without touching the router."""

    def __init__(self, rid: int, engine: GenerationEngine, *,
                 n_slots: int = 4,
                 slo: Union[SLOConfig, SLOTracker, None] = None,
                 scheduler_kwargs: Optional[Dict[str, Any]] = None):
        self.rid = int(rid)
        self.replica = f"r{rid}"
        self.engine = engine
        self.status = "live"            # live | dead | retired
        self.scheduler = ContinuousBatchingScheduler(
            engine, n_slots=n_slots, replica=self.replica, slo=slo,
            **dict(scheduler_kwargs or {}))

    # ------------------------------------------------------ wire side
    def submit_frame(self, kind: int, payload: bytes) -> Future:
        if kind != KIND_FLEET_SUBMIT:
            raise ValueError(f"replica cannot serve frame kind {kind}")
        sub = unpack_fleet_submit(payload)
        kind = RequestKind.coerce(sub["kind"])
        # session retention needs the prefix cache; without it the
        # session id still steered AFFINITY router-side, which is all
        # a dense replica can honour
        sid = sub["session_id"] if getattr(
            self.scheduler, "_prefix", None) is not None else None
        kwargs: Dict[str, Any] = {}
        if kind is RequestKind.BEAM:
            kwargs["beam_width"] = sub["beam_width"]
        elif kind is RequestKind.EMBED:
            kwargs["pooling"] = WIRE_POOLING[sub["pooling"]]
        elif kind is RequestKind.CONSTRAINED:
            # the wire carries a fixed allowlist — grammar callbacks
            # cannot cross a socket, so the frame's mask vocabulary is
            # exactly vocab_mask (rebuilt replica-side against THIS
            # engine's vocab, which also re-validates the ids)
            kwargs["token_mask"] = workloads.vocab_mask(
                sub["allowed_ids"], int(self.engine.cfg.vocab_size))
        return self.scheduler.submit(
            sub["prompt_ids"], sub["max_new_tokens"],
            temperature=sub["temperature"], top_k=sub["top_k"] or 0,
            eos_id=sub["eos_id"], session_id=sid, kind=kind, **kwargs)

    @staticmethod
    def result_frame(item: int, result) -> Tuple[int, bytes]:
        """Pack any kind's result into ONE wire shape: ids + reason +
        kind byte + a per-kind float vector (SCORE's logprobs, EMBED's
        embedding, BEAM's best total logprob)."""
        kind, floats = RequestKind.GENERATE, None
        if isinstance(result, ScoreResult):
            kind, floats = RequestKind.SCORE, result.logprobs
        elif isinstance(result, EmbedResult):
            kind, floats = RequestKind.EMBED, result.embedding
        elif isinstance(result, BeamResult):
            kind, floats = RequestKind.BEAM, [result.best_logprob]
        return KIND_FLEET_RESULT, pack_fleet_result(
            item, result.tokens, result.finish_reason,
            kind=kind.wire, floats=floats)

    # ------------------------------------------------------ signals
    def burn_rate(self) -> Optional[float]:
        """This replica's burn rate, or None when there is NO FRESH
        evidence: the SLO window prunes by latest-observed timestamp,
        so a replica traffic moved away from would otherwise freeze at
        its last (possibly terrible) verdict forever — shunned by
        least-burn routing, pinning the autoscaler's max-burn signal
        high, and never refreshing. Staleness = no observation within
        ``window_s`` of wall clock."""
        slo = self.scheduler.slo
        if slo is None:
            return None
        b = slo.burn_rate()
        if b is None:
            return None
        if time.time() - slo.latest_ts > slo.config.window_s:
            return None
        return b

    def load(self) -> float:
        s = self.scheduler
        return s.queue_depth() + s.occupancy() * s.n_slots

    def release(self):
        """Free the replica's pool and graphs (it died or retired); its
        flight recorder stays for the fleet dump."""
        self.scheduler.release()


@dataclass
class _Outstanding:
    """Router-side record of one leased request."""
    item: int
    payload: bytes              # the packed FLEET_SUBMIT frame, re-sent
    #                             verbatim on every re-route
    caller: Future
    session_id: Optional[str]
    prefix_key: bytes
    submitted_ts: float
    rid: int = -1
    replica_future: Optional[Future] = None
    reprefills: int = 0
    routed_reason: str = ""
    kind: str = "generate"      # RequestKind value


class FleetRouter:
    """N replicas, one lease table, one front door.

    Synchronous core like the scheduler: ``step()`` steps every live
    replica, collects completions, and (periodically) runs the
    autoscaler; ``run_until_idle()`` loops it. ``submit()`` packs the
    request into a fleet frame, leases it, and routes it — the returned
    future NEVER hangs: replica death re-routes its leases, and if no
    live replica remains the future fails with the cause.

    ``engine`` may be a single :class:`GenerationEngine` shared by all
    replicas (each scheduler owns its own KV cache; the engine's weights
    are shared, and on the card each cache gets its own graphs) or a
    zero-arg factory for one-engine-per-replica."""

    def __init__(self, engine: Union[GenerationEngine, Callable[[],
                 GenerationEngine]], *, n_replicas: int = 1,
                 n_slots: int = 4,
                 slo: Optional[SLOConfig] = None,
                 autoscaler: Union[Autoscaler, AutoscalerConfig,
                                   None] = None,
                 scheduler_kwargs: Optional[Dict[str, Any]] = None,
                 affinity_prefix_len: int = 16,
                 autoscale_every: int = 8,
                 snapshot_every: int = 16,
                 recorder_snapshots: int = 1024,
                 quant_kv: Optional[str] = None):
        if n_replicas < 1:
            raise ValueError("need at least one replica")
        if isinstance(engine, GenerationEngine):
            self._factory: Callable[[], GenerationEngine] = lambda: engine
        else:
            self._factory = engine
        self.n_slots = int(n_slots)
        self.slo = slo
        self._scheduler_kwargs = dict(scheduler_kwargs or {})
        # quant plumbing: the fleet-level mode reaches every
        # replica's scheduler — scale-out and scale-up replicas get the
        # same quantized pool (re-prefill after preemption re-quantizes
        # at append, so migration across replicas stays mode-blind)
        if quant_kv is not None:
            self._scheduler_kwargs["quant_kv"] = quant_kv
        self.affinity_prefix_len = int(affinity_prefix_len)
        self.autoscale_every = max(1, int(autoscale_every))
        self.snapshot_every = max(1, int(snapshot_every))
        if isinstance(autoscaler, Autoscaler):
            self.autoscaler: Optional[Autoscaler] = autoscaler
        elif autoscaler is not None:
            self.autoscaler = Autoscaler(autoscaler)
        else:
            self.autoscaler = None
        self.leases = RequestLeaseTable()
        self.outstanding: Dict[int, _Outstanding] = {}
        self.recorder = FlightRecorder(
            capacity_snapshots=recorder_snapshots, replica="fleet")
        self.replicas: Dict[int, InProcessReplica] = {}
        self._session_aff: Dict[str, int] = {}
        self._prefix_aff: Dict[bytes, int] = {}
        self._lock = threading.RLock()
        self._next_rid = 0
        self._steps = 0
        self._metrics = None
        self.ghost_results = 0
        self.reprefills = 0
        self.scale_ups = 0
        self.scale_downs = 0
        self.target_replicas = int(n_replicas)
        for _ in range(n_replicas):
            self._spawn_locked(reason="initial")

    # ------------------------------------------------------- metrics
    def _m(self):
        if self._metrics is None:
            reg = get_registry()
            self._metrics = {
                "live": reg.gauge(
                    "dl4j_fleet_replicas_live",
                    "Live replicas behind the fleet router"),
                "target": reg.gauge(
                    "dl4j_fleet_replicas_target",
                    "Autoscaler's current replica target"),
                "requests": reg.counter(
                    "dl4j_fleet_requests_total",
                    "Requests submitted to the fleet router"),
                "routed": reg.counter(
                    "dl4j_fleet_routed_total",
                    "Routing decisions, by reason (affinity = session/"
                    "prefix stickiness, least_burn = burn-rate pick, "
                    "drain = handed back by a retiring replica)",
                    labelnames=("reason",)),
                "reprefills": reg.counter(
                    "dl4j_fleet_reprefills_total",
                    "Leases re-prefilled on a survivor after replica "
                    "death"),
                "ghosts": reg.counter(
                    "dl4j_fleet_ghost_results_total",
                    "Results dropped because the sender no longer held "
                    "the lease (exactly-once accounting)"),
                "scale_events": reg.counter(
                    "dl4j_fleet_scale_events_total",
                    "Autoscaler actions, by direction",
                    labelnames=("direction",)),
            }
        return self._metrics

    # ------------------------------------------------------ replicas
    def _spawn_locked(self, reason: str = "scale_up") -> int:
        rid = self._next_rid
        self._next_rid += 1
        self.replicas[rid] = InProcessReplica(
            rid, self._factory(), n_slots=self.n_slots, slo=self.slo,
            scheduler_kwargs=self._scheduler_kwargs)
        self.recorder.record_snapshot(event="replica_spawn", rid=rid,
                                      reason=reason)
        self._export_replica_gauges_locked()
        return rid

    def _live_locked(self) -> List[InProcessReplica]:
        return [rep for _, rep in sorted(self.replicas.items())
                if rep.status == "live"]

    def _export_replica_gauges_locked(self):
        m = self._m()
        m["live"].set(float(len(self._live_locked())))
        m["target"].set(float(self.target_replicas))

    def n_live(self) -> int:
        with self._lock:
            return len(self._live_locked())

    # -------------------------------------------------------- submit
    def submit(self, prompt_ids, max_new_tokens: int = 32, *,
               temperature: float = 0.0, top_k: int = 0,
               eos_id: Optional[int] = None,
               session_id: Optional[str] = None,
               kind=RequestKind.GENERATE, beam_width: int = 0,
               pooling: str = "mean",
               allowed_ids=None) -> Future:
        """Lease + route one typed serving request; returns
        a Future resolving to a :class:`FleetResult` whose per-kind
        payload field matches ``kind``. CONSTRAINED over the wire is
        allowlist-only — ``allowed_ids`` packs into the frame and the
        replica rebuilds the vocab mask; grammar-step callbacks cannot
        cross a socket boundary (use the scheduler API directly for
        those). A kind survives replica death unchanged: the packed
        frame is re-sent verbatim, so the re-prefilled request is the
        same typed request."""
        prompt = np.asarray(prompt_ids, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("empty prompt")
        kind = RequestKind.coerce(kind)
        if kind is RequestKind.CONSTRAINED and allowed_ids is None:
            raise ValueError(
                "fleet constrained decoding needs allowed_ids (fixed "
                "allowlist; callbacks cannot cross the wire)")
        if allowed_ids is not None and kind is not RequestKind.CONSTRAINED:
            raise ValueError("allowed_ids is a CONSTRAINED knob "
                             f"(got kind={kind.value!r})")
        if pooling not in workloads.POOLING_WIRE:
            raise ValueError(f"unknown pooling {pooling!r}; expected "
                             f"one of {sorted(workloads.POOLING_WIRE)}")
        with self._lock:
            live = self._live_locked()
            if not live:
                raise RuntimeError("no live replicas")
            # validate against the engine contract BEFORE creating the
            # lease, so a rejected request never dangles in the table
            max_len = live[0].engine.max_len
            total = prompt.size if kind in (
                RequestKind.SCORE, RequestKind.EMBED) \
                else prompt.size + max_new_tokens - 1
            if total > max_len:
                raise ValueError(
                    f"prompt ({prompt.size}) + budget = {total} "
                    f"exceeds max_len={max_len}")
            item = self.leases.add()
            payload = pack_fleet_submit(
                item, prompt, max_new_tokens, temperature, top_k,
                eos_id, session_id, kind=kind.wire,
                beam_width=int(beam_width),
                pooling=workloads.POOLING_WIRE[pooling],
                allowed_ids=allowed_ids)
            rec = _Outstanding(
                item=item, payload=payload, caller=Future(),
                session_id=session_id,
                prefix_key=prompt[:self.affinity_prefix_len].tobytes(),
                submitted_ts=time.perf_counter(), kind=kind.value)
            self.outstanding[item] = rec
            self._m()["requests"].inc()
            self._route_locked(rec)
        return rec.caller

    # ------------------------------------------------------- routing
    def _pick_locked(self, rec: _Outstanding) -> Tuple[int, str]:
        live = self._live_locked()
        if not live:
            raise RuntimeError("no live replicas")
        live_ids = {rep.rid for rep in live}
        if rec.session_id is not None:
            rid = self._session_aff.get(rec.session_id)
            if rid in live_ids:
                return rid, "affinity"
        rid = self._prefix_aff.get(rec.prefix_key)
        if rid in live_ids:
            return rid, "affinity"
        inflight: Dict[int, int] = {}
        for o in self.outstanding.values():
            if o.replica_future is not None and not o.caller.done():
                inflight[o.rid] = inflight.get(o.rid, 0) + 1

        def cost(rep: InProcessReplica):
            burn = rep.burn_rate()
            return (0.0 if burn is None else burn,
                    rep.scheduler.queue_depth() + inflight.get(rep.rid, 0),
                    rep.rid)

        return min(live, key=cost).rid, "least_burn"

    def _route_locked(self, rec: _Outstanding, reason: Optional[str] = None):
        """Lease + dispatch ``rec`` onto a live replica; on total fleet
        loss the caller future FAILS rather than hangs."""
        m = self._m()
        try:
            rid, why = self._pick_locked(rec)
            if not self.leases.lease(rec.item, rid):
                raise RuntimeError(
                    f"lease {rec.item} not AVAILABLE at route time")
            rec.rid = rid
            rec.routed_reason = reason or why
            rec.replica_future = self.replicas[rid].submit_frame(
                KIND_FLEET_SUBMIT, rec.payload)
        except Exception as e:  # noqa: BLE001 — the never-hang contract
            self.outstanding.pop(rec.item, None)
            try:
                rec.caller.set_exception(e)
            except Exception:   # noqa: BLE001 — already resolved
                pass
            return
        m["routed"].inc(reason=rec.routed_reason)
        if rec.session_id is not None:
            self._session_aff[rec.session_id] = rid
        self._prefix_aff[rec.prefix_key] = rid

    # ------------------------------------------------------ stepping
    def step(self) -> bool:
        """One fleet iteration: step every live replica, collect
        completions, periodically autoscale + snapshot. Returns True if
        any work happened."""
        with self._lock:
            live = self._live_locked()
        did = False
        for rep in live:
            try:
                did = rep.scheduler.step() or did
            except Exception:   # noqa: BLE001 — a crashing replica is a
                # replica DEATH, not a fleet death: release + re-route
                self.kill_replica(rep.rid)
                did = True
        did = self._poll_completions() or did
        self._steps += 1
        if self.autoscaler is not None and \
                self._steps % self.autoscale_every == 0:
            self._autoscale()
        if self._steps % self.snapshot_every == 0:
            self._record_fleet_snapshot()
        return did

    def run_until_idle(self, max_steps: int = 200000):
        """Drive step() until every outstanding lease completed."""
        for _ in range(max_steps):
            with self._lock:
                idle = not self.outstanding
            if idle:
                return
            self.step()
        raise RuntimeError(f"fleet not idle after {max_steps} steps")

    def _poll_completions(self) -> bool:
        with self._lock:
            ready = [rec for rec in self.outstanding.values()
                     if rec.replica_future is not None
                     and rec.replica_future.done()]
        any_done = False
        m = self._m()
        for rec in ready:
            fut = rec.replica_future
            exc = fut.exception()
            with self._lock:
                if exc is not None:
                    # replica-side failure: the lease completes (the
                    # request was consumed) and the caller learns why
                    if self.leases.complete(rec.rid, rec.item):
                        self.outstanding.pop(rec.item, None)
                        try:
                            rec.caller.set_exception(exc)
                        except Exception:   # noqa: BLE001
                            pass
                        any_done = True
                    else:
                        self.ghost_results += 1
                        m["ghosts"].inc()
                    continue
                res = fut.result()
                # round-trip the result through the wire frame — the
                # boundary a socket host will speak
                _, payload = InProcessReplica.result_frame(rec.item, res)
                out = unpack_fleet_result(payload)
                if not self.leases.complete(rec.rid, rec.item):
                    self.ghost_results += 1     # exactly-once: dropped
                    m["ghosts"].inc()
                    continue
                self.outstanding.pop(rec.item, None)
                # per-kind float payload: the frame's kind
                # byte says how to read the vector; the ROUTER's record
                # names the caller-facing kind (a CONSTRAINED result
                # rides a generate-shaped frame)
                wire_kind = RequestKind.coerce(out["kind"])
                fl = out["floats"]
                result = FleetResult(
                    tokens=out["token_ids"],
                    finish_reason=out["reason"], item=rec.item,
                    replica=f"r{rec.rid}", reprefills=rec.reprefills,
                    ttft_s=res.ttft_s,
                    latency_s=time.perf_counter() - rec.submitted_ts,
                    kind=rec.kind,
                    logprobs=fl if wire_kind is RequestKind.SCORE
                    else None,
                    embedding=fl if wire_kind is RequestKind.EMBED
                    else None,
                    best_logprob=float(fl[0])
                    if wire_kind is RequestKind.BEAM and fl.size
                    else None)
            try:
                rec.caller.set_result(result)
            except Exception:   # noqa: BLE001 — caller cancelled
                pass
            any_done = True
        return any_done

    # ------------------------------------------------- fault / retire
    def kill_replica(self, rid: int) -> List[int]:
        """Simulate (or acknowledge) replica death: stop stepping it,
        release its leases, and RE-PREFILL each on a survivor — the
        recompute path, so greedy output is unchanged. Returns the item
        ids that moved."""
        with self._lock:
            rep = self.replicas.get(rid)
            if rep is None or rep.status != "live":
                return []
            rep.status = "dead"
            items = self.leases.release_replica(rid)
            m = self._m()
            for item in items:
                rec = self.outstanding.get(item)
                if rec is None:
                    continue
                rec.reprefills += 1
                self.reprefills += 1
                m["reprefills"].inc()
                self._route_locked(rec)
            self.recorder.record_snapshot(
                event="replica_dead", rid=rid, releases=len(items))
            self._export_replica_gauges_locked()
        # the dead replica's pool and graphs go; its recorder stays
        rep.release()
        return items

    def retire_replica(self, rid: int) -> int:
        """Graceful scale-down: drain the replica (in-flight requests
        FINISH on it), collect their completions, then re-route the
        unstarted queue entries it hands back. No caller future fails.
        Returns the number of entries re-routed."""
        with self._lock:
            rep = self.replicas.get(rid)
            if rep is None or rep.status != "live":
                return 0
            rep.status = "retired"      # out of routing + stepping
        # drain outside the router lock: it loops scheduler.step() —
        # real device work
        rep.scheduler.drain()
        self._poll_completions()        # harvest the drained finishes
        with self._lock:
            moved = 0
            for item in self.leases.release_replica(rid):
                rec = self.outstanding.get(item)
                if rec is None:
                    continue
                self._route_locked(rec, reason="drain")
                moved += 1
            self.recorder.record_snapshot(
                event="replica_retired", rid=rid, handed_back=moved)
            self._export_replica_gauges_locked()
        rep.release()
        return moved

    # ---------------------------------------------------- autoscaler
    def _signals_locked(self) -> Tuple[Optional[float], float, int]:
        live = self._live_locked()
        n = len(live)
        burns = [b for b in (rep.burn_rate() for rep in live)
                 if b is not None]
        burn = max(burns) if burns else None
        total_q = sum(rep.scheduler.queue_depth() for rep in live)
        return burn, total_q / max(n, 1), n

    def _autoscale(self):
        with self._lock:
            burn, qpr, n = self._signals_locked()
            decision = self.autoscaler.evaluate(burn, qpr, n)
            if decision > 0:
                self.target_replicas = n + 1
                rid = self._spawn_locked(reason="burn")
                self.scale_ups += 1
                self._m()["scale_events"].inc(direction="up")
                self.recorder.record_snapshot(
                    event="scale", scale_event="up", rid=rid, burn=burn,
                    queue_per_replica=round(qpr, 3), replicas_live=n + 1,
                    replicas_target=self.target_replicas)
                return
            if decision < 0:
                victim = min(self._live_locked(),
                             key=lambda rep: (rep.load(), rep.rid))
                self.target_replicas = n - 1
        if decision < 0:
            self.retire_replica(victim.rid)
            self.scale_downs += 1
            self._m()["scale_events"].inc(direction="down")
            with self._lock:
                self.recorder.record_snapshot(
                    event="scale", scale_event="down", rid=victim.rid,
                    burn=burn, queue_per_replica=round(qpr, 3),
                    replicas_live=n - 1,
                    replicas_target=self.target_replicas)
                self._export_replica_gauges_locked()

    def _record_fleet_snapshot(self):
        with self._lock:
            burn, qpr, n = self._signals_locked()
            self.recorder.record_snapshot(
                step=self._steps, replicas_live=n,
                replicas_target=self.target_replicas,
                outstanding=len(self.outstanding),
                queue_per_replica=round(qpr, 3),
                burn=None if burn is None else round(burn, 4),
                reprefills=self.reprefills,
                scale_ups=self.scale_ups, scale_downs=self.scale_downs)

    # ------------------------------------------------------- reports
    def fleet_report(self) -> Dict[str, Any]:
        with self._lock:
            burn, qpr, n = self._signals_locked()
            reps = {}
            for rid, rep in sorted(self.replicas.items()):
                r: Dict[str, Any] = {"status": rep.status}
                if rep.status == "live":
                    r["queue_depth"] = rep.scheduler.queue_depth()
                    r["occupancy"] = rep.scheduler.occupancy()
                    b = rep.burn_rate()
                    if b is not None:
                        r["burn_rate"] = round(b, 4)
                reps[rep.replica] = r
            return {"replicas": reps, "live": n,
                    "target": self.target_replicas,
                    "leases": self.leases.counts(),
                    "outstanding": len(self.outstanding),
                    "queue_per_replica": round(qpr, 3),
                    "burn": None if burn is None else round(burn, 4),
                    "reprefills": self.reprefills,
                    "ghost_results": self.ghost_results,
                    "scale_ups": self.scale_ups,
                    "scale_downs": self.scale_downs}

    def dump(self, path=None, reason: str = "fleet_episode") -> str:
        """Append the fleet recorder plus EVERY replica's recorder
        (live, dead and retired) into one JSONL —
        ``scripts/slo_report.py --fleet`` replays it."""
        self._record_fleet_snapshot()
        out = self.recorder.dump(path, reason=reason)
        with self._lock:
            reps = [rep for _, rep in sorted(self.replicas.items())]
        for rep in reps:
            rep.scheduler.flight_recorder.dump(out, reason=reason)
        return str(out)
