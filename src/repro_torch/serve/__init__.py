"""repro_torch.serve — continuous-batching inference on the symmetric
heap, on the GPU: paged KV cache with a migratable prefix cache, FCFS
scheduler with token-budgeted chunked prefill and an optional SLO
policy, speculative decoding, the sampler, and the engine.

    from repro_torch import serve
    eng = serve.ServeEngine(params, cfg, serve.ServeConfig())
    done = eng.run(serve.make_requests(serve.TrafficConfig()))
    eng.metrics()
"""
from .engine import (LocalExec, ServeConfig, ServeEngine, make_decode_step,
                     make_prefill, make_verify, slo_summary)
from .kv_cache import NULL_PAGE, PagedKVCache, PageMigration
from .sampling import (GREEDY, SamplingParams, batch_state,
                       sample_from_candidates, sample_tokens,
                       sample_window_tokens)
from .scheduler import FCFSScheduler, Request, TickPlan
from .slo import PRIORITIES, SLOConfig, SLOPolicy
from .spec import (DraftModelProposer, FixedProposer, NgramProposer,
                   ReplayProposer, SpecProposer, make_proposer)
from .traffic import TrafficConfig, make_requests

__all__ = [
    "ServeConfig", "ServeEngine", "LocalExec",
    "make_decode_step", "make_prefill", "make_verify", "slo_summary",
    "PagedKVCache", "PageMigration", "NULL_PAGE",
    "FCFSScheduler", "Request", "TickPlan",
    "SLOConfig", "SLOPolicy", "PRIORITIES",
    "SpecProposer", "NgramProposer", "ReplayProposer", "FixedProposer",
    "DraftModelProposer", "make_proposer",
    "TrafficConfig", "make_requests",
    "SamplingParams", "GREEDY", "batch_state",
    "sample_from_candidates", "sample_tokens", "sample_window_tokens",
]
