"""Partition lease table — the elastic re-partitioning half of the
scale-out plane. Port of ``deeplearning4j_tpu/parallel/leases.py``: the
same states, grants, snapshots and exactly-once contract (plain host
Python, no device).

The reference Spark ``ParameterAveragingTrainingMaster`` never loses a
partition: a failed executor's split is re-provisioned onto a
replacement and re-run. The drop-only scheme this replaces lost the
dead worker's partition silently (the survivors just averaged over less
data). Here the master holds a table of work items — one per
``(epoch, shard)`` pair, epoch-major — and workers *lease* items one at
a time over the wire instead of receiving a static partition at spawn:

- **affinity**: item ``i`` prefers the worker slot
  ``(i % n_shards) % n_workers``, which reproduces the old round-robin
  static partitioning exactly while every worker is alive (so the
  freq-1 averaging-equivalence anchor still holds bit-for-bit);
- **reassignment**: when a worker dies (or never shows up), its leases
  return to the pool and its *affinity slot* becomes stealable — a
  survivor or rejoiner picks the items up, so job output covers every
  partition regardless of the failure schedule;
- **exactly-once accounting**: each item is completed at most once in
  the table (stale completions from a dropped worker's ghost are
  ignored unless the item is still unclaimed), and the job is done when
  ``all_done()``;
- **resume**: ``snapshot()``/``restore()`` round-trip the completed set
  through the between-round checkpoint (``leases.json``), so a
  restarted master re-runs only the unfinished items.

At-least-once caveat: an item completed after the last checkpoint but
before a master crash, or in flight when its worker died, is re-run.
Parameter averaging tolerates the duplicated fit; the table's
``completed`` set still counts each item once.

The table is self-locking (leaf lock — it never calls out), so the hub
may use it from any handler thread and the fast unit suite can exercise
the invariants without sockets.
"""

from __future__ import annotations

import json
import threading
from typing import Dict, Iterable, List, Optional, Tuple

AVAILABLE, LEASED, DONE = 0, 1, 2

#: grant statuses returned by :meth:`LeaseTable.acquire`
GRANT_NONE = 0      # nothing for this worker, now or later — wrap up
GRANT_OK = 1        # payload carries the granted item id
GRANT_RETRY = 2     # provisioning window: items exist whose affine
#                     owner has not registered yet — ask again shortly


class LeaseTable:
    """Lease table over ``n_shards * epochs`` work items."""

    def __init__(self, n_shards: int, epochs: int = 1, n_workers: int = 1,
                 completed: Iterable[int] = ()):
        if n_shards < 1 or epochs < 1 or n_workers < 1:
            raise ValueError("n_shards, epochs, n_workers must be >= 1")
        self.n_shards = n_shards
        self.epochs = epochs
        self.n_workers = n_workers
        self.n_items = n_shards * epochs
        self._lock = threading.Lock()
        self._state = [AVAILABLE] * self.n_items
        self._owner: List[Optional[int]] = [None] * self.n_items
        self._prev: List[Optional[int]] = [None] * self.n_items
        self.reassigned = 0     # grants to a non-affine worker
        for i in completed:
            i = int(i)
            if not 0 <= i < self.n_items:
                raise ValueError(f"completed item {i} out of range "
                                 f"[0, {self.n_items})")
            self._state[i] = DONE

    # ------------------------------------------------------------ geometry
    def shard_of(self, item: int) -> int:
        return item % self.n_shards

    def epoch_of(self, item: int) -> int:
        return item // self.n_shards

    def affinity_of(self, item: int) -> int:
        """The worker *slot* (wid mod n_workers) this item prefers —
        matches the old static round-robin ``parts[i % n_workers]``."""
        return (item % self.n_shards) % self.n_workers

    # ------------------------------------------------------------ leasing
    def acquire(self, wid: int,
                stealable_slots: Iterable[int] = (),
                unsettled_slots: Iterable[int] = ()) -> Tuple[int, int]:
        """Try to lease an item for worker ``wid``.

        ``stealable_slots``: affinity slots whose owner is known absent
        (dead or departed) — their items may be reassigned.
        ``unsettled_slots``: slots whose owner has not registered *yet*
        (the provisioning window) — their items are held back and the
        caller is told to retry rather than steal prematurely.

        Returns ``(status, item)`` with status one of GRANT_OK /
        GRANT_NONE / GRANT_RETRY (item is only meaningful for GRANT_OK).
        Item ids are granted in ascending order, i.e. epoch-major FIFO.
        """
        aff = wid % self.n_workers
        steal = set(stealable_slots)
        unsettled = set(unsettled_slots)
        with self._lock:
            steal_pick = None
            saw_unsettled = False
            for i, st in enumerate(self._state):
                if st != AVAILABLE:
                    continue
                slot = self.affinity_of(i)
                if slot == aff:
                    return self._grant_locked(i, wid)
                if steal_pick is None and slot in steal:
                    steal_pick = i          # keep scanning for an affine one
                elif slot in unsettled:
                    saw_unsettled = True
            if steal_pick is not None:
                return self._grant_locked(steal_pick, wid)
            if saw_unsettled:
                return GRANT_RETRY, -1
            return GRANT_NONE, -1

    def _grant_locked(self, item: int, wid: int) -> Tuple[int, int]:
        self._state[item] = LEASED
        if self.affinity_of(item) != wid % self.n_workers or \
                self._prev[item] not in (None, wid):
            self.reassigned += 1
        self._owner[item] = wid
        return GRANT_OK, item

    def complete(self, wid: int, item: int) -> bool:
        """Mark ``item`` done by ``wid``. Stale completions (the item was
        released and re-leased to someone else, or already done) are
        ignored — each item counts DONE exactly once."""
        if not 0 <= item < self.n_items:
            return False
        with self._lock:
            st = self._state[item]
            if st == LEASED and self._owner[item] == wid:
                self._state[item] = DONE
                self._owner[item] = None
                return True
            if st == AVAILABLE and self._prev[item] == wid:
                # the worker was dropped (lease released) but its DONE
                # arrived anyway — accept, sparing a re-run
                self._state[item] = DONE
                return True
            return False

    def release_worker(self, wid: int) -> List[int]:
        """Return all of ``wid``'s unfinished leases to the pool."""
        out = []
        with self._lock:
            for i, st in enumerate(self._state):
                if st == LEASED and self._owner[i] == wid:
                    self._state[i] = AVAILABLE
                    self._owner[i] = None
                    self._prev[i] = wid
                    out.append(i)
        return out

    # ------------------------------------------------------------ queries
    def all_done(self) -> bool:
        with self._lock:
            return all(st == DONE for st in self._state)

    @property
    def completed(self) -> Tuple[int, ...]:
        with self._lock:
            return tuple(i for i, st in enumerate(self._state)
                         if st == DONE)

    def counts(self) -> Dict[str, int]:
        with self._lock:
            return {"available": self._state.count(AVAILABLE),
                    "leased": self._state.count(LEASED),
                    "done": self._state.count(DONE),
                    "reassigned": self.reassigned}

    # ------------------------------------------------------------ resume
    def snapshot(self) -> str:
        """JSON snapshot for the between-round checkpoint."""
        return json.dumps({"n_shards": self.n_shards,
                           "epochs": self.epochs,
                           "completed": list(self.completed)})

    @staticmethod
    def restore(snapshot: str, n_shards: int, epochs: int,
                n_workers: int) -> Optional["LeaseTable"]:
        """Rebuild a table from ``snapshot`` if its geometry matches the
        (n_shards, epochs) of the new job; None = start fresh (the
        checkpoint belongs to a different job shape)."""
        try:
            d = json.loads(snapshot)
            if int(d["n_shards"]) != n_shards or int(d["epochs"]) != epochs:
                return None
            return LeaseTable(n_shards, epochs, n_workers,
                              completed=[int(i) for i in d["completed"]])
        except (ValueError, KeyError, TypeError):
            return None


class RequestLeaseTable:
    """Lease table over an UNBOUNDED request stream — the serving-fleet
    sibling of :class:`LeaseTable`.

    The training table's geometry is fixed at construction (``n_shards *
    epochs`` items, affinity by slot arithmetic); a serving fleet sees an
    open-ended arrival stream and routes by burn-rate/session affinity
    *outside* the table. What carries over unchanged is the completion
    contract: every item is completed **exactly once** no matter how many
    replicas die holding it, stale completions from a replica whose lease
    was released-and-re-granted are ignored, and ``release_replica``
    returns the dead replica's in-flight items so the router can re-lease
    them on survivors. Same state constants, same leaf-lock discipline.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._state: Dict[int, int] = {}
        self._owner: Dict[int, Optional[int]] = {}
        self._prev: Dict[int, Optional[int]] = {}
        self._next = 0
        self.reassigned = 0      # leases granted after a release

    def add(self) -> int:
        """Register a new work item; returns its id (monotonic)."""
        with self._lock:
            item = self._next
            self._next += 1
            self._state[item] = AVAILABLE
            self._owner[item] = None
            self._prev[item] = None
            return item

    def lease(self, item: int, replica: int) -> bool:
        """Grant ``item`` to ``replica``. False if unknown / already
        leased or done (the router must release before re-leasing)."""
        with self._lock:
            if self._state.get(item) != AVAILABLE:
                return False
            self._state[item] = LEASED
            if self._prev[item] is not None:
                self.reassigned += 1
            self._owner[item] = replica
            return True

    def owner_of(self, item: int) -> Optional[int]:
        with self._lock:
            return self._owner.get(item)

    def complete(self, replica: int, item: int) -> bool:
        """Exactly-once completion: True iff ``replica`` currently holds
        the lease (or held it when the item was released and no one has
        re-leased it since — the late-DONE-from-a-ghost case). A result
        arriving from a presumed-dead replica AFTER the item was re-leased
        elsewhere returns False and must be dropped by the caller."""
        with self._lock:
            st = self._state.get(item)
            if st == LEASED and self._owner[item] == replica:
                self._state[item] = DONE
                self._owner[item] = None
                return True
            if st == AVAILABLE and self._prev[item] == replica:
                self._state[item] = DONE
                return True
            return False

    def release_replica(self, replica: int) -> List[int]:
        """Return all of ``replica``'s unfinished leases to the pool (in
        item order) so they can be re-leased on survivors."""
        out = []
        with self._lock:
            for item in sorted(self._state):
                if self._state[item] == LEASED and \
                        self._owner[item] == replica:
                    self._state[item] = AVAILABLE
                    self._owner[item] = None
                    self._prev[item] = replica
                    out.append(item)
        return out

    def all_done(self) -> bool:
        with self._lock:
            return all(st == DONE for st in self._state.values())

    def counts(self) -> Dict[str, int]:
        with self._lock:
            vals = list(self._state.values())
            return {"available": vals.count(AVAILABLE),
                    "leased": vals.count(LEASED),
                    "done": vals.count(DONE),
                    "reassigned": self.reassigned}
