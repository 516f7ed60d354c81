"""Serving plane of the port: KV cache and prefix cache, generation engine,
continuous batching, typed requests."""

from .engine import DEFAULT_PREFILL_BUCKETS, GenerationEngine, sample_tokens
from .kvcache import PageTable, PrefixCache
from .scheduler import (ContinuousBatchingScheduler, GenerationResult,
                        ServingRequest)
from .workloads import (BeamResult, EmbedResult, RequestKind, ScoreResult,
                        vocab_mask)

__all__ = ["BeamResult", "ContinuousBatchingScheduler",
           "DEFAULT_PREFILL_BUCKETS", "EmbedResult", "GenerationEngine",
           "GenerationResult", "PageTable", "PrefixCache", "RequestKind",
           "ScoreResult", "ServingRequest", "sample_tokens", "vocab_mask"]
