"""Serving plane of the port: KV cache and prefix cache, generation engine,
continuous batching, typed requests; the quantization plane (int8 KV pages
and weights behind fidelity-gated races, ``quant``), speculative decoding
(``spec``) and the serving-knob sweep (``tune``); the SLO plane's config
and tracker (``obs.slo``) re-exported for the scheduler's ``slo=``;
``FunctionalInferenceModel``, which serves a functional forward (BERT)
through ``parallel.ParallelInference``."""

from ..obs import SLOConfig, SLOTracker
from .adapter import FunctionalInferenceModel
from .engine import DEFAULT_PREFILL_BUCKETS, GenerationEngine, sample_tokens
from .kvcache import (DEFAULT_PAGE_LEN, DEFAULT_PREFILL_CHUNK, PageTable,
                      PrefixCache, cache_len, cache_nbytes, cache_slots,
                      init_cache, init_paged_cache, is_paged, is_quantized,
                      page_nbytes, token_nbytes)
from .quant import (decide_kv, decide_weights, quantize_rows,
                    quantized_params, race_kv, race_weights)
from .scheduler import (ContinuousBatchingScheduler, GenerationResult,
                        ServingRequest)
from .spec import EngineDraft, NgramDraft, SpeculativeDecoder, race_spec
from .workloads import (BeamResult, EmbedResult, RequestKind, ScoreResult,
                        vocab_mask)

__all__ = ["BeamResult", "ContinuousBatchingScheduler", "DEFAULT_PAGE_LEN",
           "DEFAULT_PREFILL_BUCKETS", "DEFAULT_PREFILL_CHUNK", "EmbedResult",
           "EngineDraft", "FunctionalInferenceModel", "GenerationEngine",
           "GenerationResult", "NgramDraft", "PageTable", "PrefixCache",
           "RequestKind", "SLOConfig", "SLOTracker", "ScoreResult",
           "ServingRequest", "SpeculativeDecoder", "cache_len", "cache_nbytes",
           "cache_slots", "decide_kv", "decide_weights", "init_cache",
           "init_paged_cache", "is_paged", "is_quantized", "page_nbytes",
           "quantize_rows", "quantized_params", "race_kv", "race_spec",
           "race_weights", "sample_tokens", "token_nbytes", "vocab_mask"]
