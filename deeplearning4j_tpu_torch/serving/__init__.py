"""Serving plane of the port: KV cache and prefix cache, generation engine,
continuous batching, typed requests; the quantization plane (int8 KV pages
and weights behind fidelity-gated races, ``quant``), speculative decoding
(``spec``) and the serving-knob sweep (``tune``); the SLO plane's config
and tracker (``obs.slo``) re-exported for the scheduler's ``slo=``;
``FunctionalInferenceModel``, which serves a functional forward (BERT)
through ``parallel.ParallelInference``; and the fleet fabric above the
scheduler — ``FleetRouter`` over scheduler-wrapped replicas with leased
requests, affinity and least-burn routing, re-prefill on replica death,
drain and SLO-driven autoscaling (``fleet``), driven by open-loop Poisson
episodes (``traffic``: ``run_episode``)."""

from ..obs import SLOConfig, SLOTracker
from .adapter import FunctionalInferenceModel
from .engine import DEFAULT_PREFILL_BUCKETS, GenerationEngine, sample_tokens
from .fleet import (Autoscaler, AutoscalerConfig, FleetResult, FleetRouter,
                    InProcessReplica)
from .kvcache import (DEFAULT_PAGE_LEN, DEFAULT_PREFILL_CHUNK, PageTable,
                      PrefixCache, cache_len, cache_nbytes, cache_slots,
                      init_cache, init_paged_cache, is_paged, is_quantized,
                      page_nbytes, token_nbytes)
from .quant import (decide_kv, decide_weights, quantize_rows,
                    quantized_params, race_kv, race_weights)
from .scheduler import (ContinuousBatchingScheduler, GenerationResult,
                        ServingRequest)
from .spec import EngineDraft, NgramDraft, SpeculativeDecoder, race_spec
from .traffic import (Arrival, EpisodeReport, TrafficConfig,
                      poisson_arrivals, run_episode)
from .workloads import (BeamResult, EmbedResult, RequestKind, ScoreResult,
                        vocab_mask)

__all__ = ["Arrival", "Autoscaler", "AutoscalerConfig", "BeamResult",
           "ContinuousBatchingScheduler", "DEFAULT_PAGE_LEN",
           "DEFAULT_PREFILL_BUCKETS", "DEFAULT_PREFILL_CHUNK", "EmbedResult",
           "EngineDraft", "EpisodeReport", "FleetResult", "FleetRouter",
           "FunctionalInferenceModel", "GenerationEngine", "InProcessReplica",
           "GenerationResult", "NgramDraft", "PageTable", "PrefixCache",
           "RequestKind", "SLOConfig", "SLOTracker", "ScoreResult",
           "ServingRequest", "SpeculativeDecoder", "TrafficConfig",
           "cache_len", "cache_nbytes", "cache_slots", "decide_kv",
           "decide_weights", "init_cache", "init_paged_cache", "is_paged",
           "is_quantized", "page_nbytes", "poisson_arrivals", "quantize_rows",
           "quantized_params", "race_kv", "race_spec", "race_weights",
           "run_episode", "sample_tokens", "token_nbytes", "vocab_mask"]
