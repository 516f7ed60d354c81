"""Open-loop traffic generation for the fleet fabric. Port of
``deeplearning4j_tpu/serving/traffic.py`` (the same seeded trace, draw for
draw).

Serving benchmarks that submit the next request only after the last one
finished (closed-loop) can never observe queueing collapse — the
arrival process slows down exactly when the system does. This module
generates OPEN-LOOP Poisson arrivals: exponential inter-arrival gaps at
a configured rate, independent of completion, with mixed prompt/output
lengths and an optional burst window where the rate multiplies. That is
the traffic shape under which the autoscaler's burn/queue signals mean
something.

``run_episode`` paces the trace against the wall clock through a
:class:`~.fleet.FleetRouter`: arrivals whose time has come are
submitted, the router steps, and an optional fault injection kills the
busiest replica mid-episode (the re-prefill path under live load). The
episode ends when every future resolved, and dumps the whole fleet
black box for ``scripts/slo_report.py --fleet`` replay.

Everything is seeded — the same config replays the same arrivals.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from .fleet import FleetRouter


@dataclass(frozen=True)
class TrafficConfig:
    """One episode's arrival process."""
    rate_rps: float = 20.0          # base arrival rate
    duration_s: float = 2.0         # arrivals stop after this
    prompt_lens: Tuple[int, ...] = (4, 8, 16)
    max_new_tokens: Tuple[int, ...] = (4, 8)
    vocab: int = 256                # prompt ids drawn from [1, vocab)
    burst_start_s: Optional[float] = None
    burst_end_s: Optional[float] = None
    burst_mult: float = 4.0         # rate multiplier inside the burst
    sessions: int = 0               # >0: requests cycle this many
    #                                 session ids (affinity traffic)
    temperature: float = 0.0
    seed: int = 0

    def rate_at(self, t: float) -> float:
        if self.burst_start_s is not None and self.burst_end_s is not None \
                and self.burst_start_s <= t < self.burst_end_s:
            return self.rate_rps * self.burst_mult
        return self.rate_rps


@dataclass(frozen=True)
class Arrival:
    t: float                        # seconds from episode start
    prompt: np.ndarray
    max_new_tokens: int
    session_id: Optional[str]


def poisson_arrivals(cfg: TrafficConfig) -> List[Arrival]:
    """The seeded open-loop trace: piecewise-homogeneous Poisson (the
    gap after time t is drawn at rate ``cfg.rate_at(t)``)."""
    rng = np.random.default_rng(cfg.seed)
    out: List[Arrival] = []
    t = 0.0
    while True:
        t += float(rng.exponential(1.0 / cfg.rate_at(t)))
        if t >= cfg.duration_s:
            return out
        plen = int(rng.choice(np.asarray(cfg.prompt_lens)))
        prompt = rng.integers(1, cfg.vocab, size=plen,
                              dtype=np.int64).astype(np.int32)
        mnt = int(rng.choice(np.asarray(cfg.max_new_tokens)))
        sid = f"s{int(rng.integers(cfg.sessions))}" if cfg.sessions \
            else None
        out.append(Arrival(t=t, prompt=prompt, max_new_tokens=mnt,
                           session_id=sid))


@dataclass
class EpisodeReport:
    submitted: int
    completed: int
    failed: int
    wall_s: float
    killed_rid: Optional[int]
    dump_path: Optional[str]
    fleet: dict
    futures: list = field(default_factory=list, repr=False)


def _busiest_live_rid(router: FleetRouter) -> Optional[int]:
    """The live replica holding the most outstanding leases (ties to
    the lowest rid); None when killing it would leave no survivor."""
    with router._lock:
        live = router._live_locked()
        if len(live) < 2:
            return None
        held = {rep.rid: 0 for rep in live}
        for rec in router.outstanding.values():
            if rec.rid in held:
                held[rec.rid] += 1
        return max(sorted(held), key=lambda rid: held[rid])


def run_episode(router: FleetRouter, cfg: TrafficConfig, *,
                kill_at_s: Optional[float] = None,
                dump_path=None, max_wall_s: float = 120.0,
                eos_id: Optional[int] = None) -> EpisodeReport:
    """Pace ``cfg``'s trace through ``router`` against the wall clock.

    ``kill_at_s`` injects one replica death at that episode time (the
    busiest live replica, skipped if no survivor would remain);
    ``dump_path`` appends the fleet black box there at episode end.
    Raises if the episode exceeds ``max_wall_s`` — no hidden hang."""
    arrivals = poisson_arrivals(cfg)
    futures = []
    killed: Optional[int] = None
    t0 = time.perf_counter()
    i = 0
    while True:
        now = time.perf_counter() - t0
        if now > max_wall_s:
            raise RuntimeError(
                f"episode exceeded max_wall_s={max_wall_s} "
                f"({len(futures)} submitted, "
                f"{len(router.outstanding)} outstanding)")
        if kill_at_s is not None and killed is None and now >= kill_at_s:
            rid = _busiest_live_rid(router)
            if rid is not None:
                router.kill_replica(rid)
                killed = rid
        while i < len(arrivals) and arrivals[i].t <= now:
            a = arrivals[i]
            i += 1
            futures.append(router.submit(
                a.prompt, a.max_new_tokens,
                temperature=cfg.temperature, eos_id=eos_id,
                session_id=a.session_id))
        worked = router.step()
        if i >= len(arrivals) and not router.outstanding:
            break
        if not worked and i < len(arrivals):
            # idle with the next arrival still in the future: nap until
            # it (bounded — the router stays responsive to the clock)
            time.sleep(max(0.0, min(arrivals[i].t - now, 0.005)))
    wall = time.perf_counter() - t0
    completed = sum(1 for f in futures
                    if f.done() and f.exception() is None)
    failed = sum(1 for f in futures
                 if f.done() and f.exception() is not None)
    dump = router.dump(dump_path) if dump_path is not None else None
    return EpisodeReport(submitted=len(futures), completed=completed,
                         failed=failed, wall_s=round(wall, 3),
                         killed_rid=killed, dump_path=dump,
                         fleet=router.fleet_report(), futures=futures)
