"""Typed serving requests. Port of ``deeplearning4j_tpu/serving/workloads.py``
(host-only numpy, copied into the port and never imported from it).

- :class:`RequestKind` — what ``submit(kind=...)`` takes:

  * ``GENERATE`` — the continuation path;
  * ``SCORE`` — prefill-only chunked passes returning per-token logprobs
    and the sequence's perplexity (the request retires at its final
    prefill chunk and never takes decode-sweep time);
  * ``EMBED`` — the pooled post-``ln_f`` hidden state of the prompt
    (prefill-only as well);
  * ``BEAM`` — width-k beam search over the paged pool: the beams
    ``map_shared`` the root's prefix pages and split only where they
    diverge (copy on write), so k beams of length T hold about
    T + k·divergent pages, not k·T;
  * ``CONSTRAINED`` — a per-request token mask (a vocabulary allowlist
    or a grammar-step callback) applied inside the engine's masked
    sampler.

- the result dataclasses (:class:`ScoreResult`, :class:`EmbedResult`,
  :class:`BeamResult`), each with ``tokens`` and ``finish_reason`` so
  that every kind reads alike;
- :class:`BeamState`, the scheduler's host-side record of a beam group;
- :func:`vocab_mask`, allowlist → bool mask, and :func:`resolve_mask`.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Union

import numpy as np


class RequestKind(enum.Enum):
    """The typed request plane. Values are the human-facing strings;
    :attr:`wire` is the single byte a fleet SUBMIT frame carries."""

    GENERATE = "generate"
    SCORE = "score"
    EMBED = "embed"
    BEAM = "beam"
    CONSTRAINED = "constrained"

    @property
    def wire(self) -> int:
        return _KIND_WIRE[self]

    @classmethod
    def coerce(cls, value) -> "RequestKind":
        """Accept a RequestKind, its string value (case-insensitive) or
        its wire byte."""
        if isinstance(value, cls):
            return value
        if isinstance(value, str):
            try:
                return cls(value.lower())
            except ValueError:
                raise ValueError(
                    f"unknown request kind {value!r}; expected one of "
                    f"{[k.value for k in cls]}") from None
        if isinstance(value, (int, np.integer)):
            try:
                return _WIRE_KIND[int(value)]
            except KeyError:
                raise ValueError(
                    f"unknown request-kind wire byte {int(value)}"
                ) from None
        raise ValueError(f"cannot coerce {type(value).__name__} to "
                         "RequestKind")


_KIND_WIRE = {RequestKind.GENERATE: 0, RequestKind.SCORE: 1,
              RequestKind.EMBED: 2, RequestKind.BEAM: 3,
              RequestKind.CONSTRAINED: 4}
_WIRE_KIND = {v: k for k, v in _KIND_WIRE.items()}

#: every kind value, in wire order
ALL_KINDS = tuple(k.value for k in sorted(RequestKind,
                                          key=lambda k: k.wire))

#: EMBED pooling modes and their wire bytes
POOLING_WIRE = {"mean": 0, "last": 1}
WIRE_POOLING = {v: k for k, v in POOLING_WIRE.items()}

#: a CONSTRAINED mask: a fixed (V,) bool allow-array, or a callback
#: ``step(generated_ids: List[int]) -> (V,) bool array`` consulted before
#: every sampled token (grammar stepping)
TokenMask = Union[np.ndarray, Callable[[List[int]], np.ndarray]]


def vocab_mask(allowed_ids, vocab_size: int) -> np.ndarray:
    """(V,) bool mask admitting exactly ``allowed_ids``."""
    ids = np.asarray(allowed_ids, np.int64).reshape(-1)
    if ids.size == 0:
        raise ValueError("empty allowlist would mask every token")
    if ids.min() < 0 or ids.max() >= vocab_size:
        raise ValueError(
            f"allowlist ids outside [0, {vocab_size})")
    mask = np.zeros((vocab_size,), bool)
    mask[ids] = True
    return mask


def resolve_mask(mask: TokenMask, generated: List[int],
                 vocab_size: int) -> np.ndarray:
    """The (V,) bool mask for the NEXT sampled token: a fixed array
    passes through (validated once at submit), a callback is consulted
    with the tokens generated so far."""
    m = mask(list(generated)) if callable(mask) else mask
    m = np.asarray(m, bool).reshape(-1)
    if m.shape != (vocab_size,):
        raise ValueError(f"token mask shape {m.shape} != "
                         f"({vocab_size},)")
    if not m.any():
        raise ValueError("token mask admits no token")
    return m


# --------------------------------------------------------------------------
# Result payloads: each carries tokens and finish_reason
# --------------------------------------------------------------------------

@dataclass
class ScoreResult:
    """SCORE verdict: ``logprobs[i]`` is log P(prompt[i+1] | prompt[:i+1])
    — length ``len(prompt) - 1`` (position 0 is unconditional and
    skipped); ``perplexity = exp(-mean(logprobs))``."""
    logprobs: np.ndarray
    perplexity: float
    prompt_tokens: int
    finish_reason: str = "complete"
    ttft_s: Optional[float] = None
    latency_s: float = 0.0
    prefill_s: float = 0.0
    tokens: np.ndarray = field(
        default_factory=lambda: np.zeros((0,), np.int32))

    @property
    def total_logprob(self) -> float:
        return float(np.sum(self.logprobs))


@dataclass
class EmbedResult:
    """EMBED verdict: the pooled post-``ln_f`` last-layer hidden state,
    f32 ``(d_model,)``. ``pooling`` is "mean" (token average) or "last"
    (the final position's row)."""
    embedding: np.ndarray
    pooling: str
    prompt_tokens: int
    finish_reason: str = "complete"
    ttft_s: Optional[float] = None
    latency_s: float = 0.0
    prefill_s: float = 0.0
    tokens: np.ndarray = field(
        default_factory=lambda: np.zeros((0,), np.int32))


@dataclass
class BeamResult:
    """BEAM verdict: hypotheses sorted by total logprob, best first.
    ``tokens`` is the best sequence (prompt excluded)."""
    sequences: List[np.ndarray]
    scores: List[float]
    beam_width: int
    finish_reason: str = "length"
    ttft_s: Optional[float] = None
    latency_s: float = 0.0
    prefill_s: float = 0.0

    @property
    def tokens(self) -> np.ndarray:
        return self.sequences[0] if self.sequences else \
            np.zeros((0,), np.int32)

    @property
    def best_logprob(self) -> float:
        return self.scores[0] if self.scores else float("-inf")


@dataclass
class BeamState:
    """Host-side record of one live beam group (scheduler internal).
    ``slots[i]`` is the decode slot serving live beam ``i``;
    ``tokens[i]`` / ``scores[i]`` its generated ids and total logprob.
    ``done`` collects finished hypotheses (their slots are released at
    once — the width shrinks). ``expanded`` flips once the root prefill
    has fanned out into the group's slots."""
    width: int
    slots: List[int] = field(default_factory=list)
    tokens: List[List[int]] = field(default_factory=list)
    scores: List[float] = field(default_factory=list)
    done: List[tuple] = field(default_factory=list)   # (ids, score)
    expanded: bool = False

    def progress(self) -> int:
        """Generated length (the live beams advance in lockstep)."""
        if self.tokens:
            return len(self.tokens[0])
        return max((len(ids) for ids, _ in self.done), default=0)
