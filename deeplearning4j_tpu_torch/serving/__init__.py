"""Serving plane of the port: KV cache, generation engine, continuous
batching."""

from .engine import DEFAULT_PREFILL_BUCKETS, GenerationEngine, sample_tokens
from .kvcache import PageTable
from .scheduler import (ContinuousBatchingScheduler, GenerationResult,
                        ServingRequest)

__all__ = ["ContinuousBatchingScheduler", "DEFAULT_PREFILL_BUCKETS",
           "GenerationEngine", "GenerationResult", "PageTable",
           "ServingRequest", "sample_tokens"]
