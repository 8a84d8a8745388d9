"""repro_torch.serve — continuous-batching inference on the symmetric
heap, on the GPU: paged KV cache, FCFS scheduler with token-budgeted
chunked prefill, the sampler, and the engine.

    from repro_torch import serve
    eng = serve.ServeEngine(params, cfg, serve.ServeConfig())
    done = eng.run(serve.make_requests(serve.TrafficConfig()))
    eng.metrics()
"""
from .engine import LocalExec, ServeConfig, ServeEngine, make_decode_step, \
    make_prefill
from .kv_cache import NULL_PAGE, PagedKVCache
from .sampling import (GREEDY, SamplingParams, batch_state,
                       sample_from_candidates, sample_tokens)
from .scheduler import FCFSScheduler, Request, TickPlan
from .traffic import TrafficConfig, make_requests

__all__ = [
    "ServeConfig", "ServeEngine", "LocalExec",
    "make_decode_step", "make_prefill",
    "PagedKVCache", "NULL_PAGE",
    "FCFSScheduler", "Request", "TickPlan",
    "TrafficConfig", "make_requests",
    "SamplingParams", "GREEDY", "batch_state",
    "sample_from_candidates", "sample_tokens",
]
