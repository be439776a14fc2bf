from .engine import ContinuousBatchingEngine, Request, SamplingParams
from .generate import decode_loop, greedy_generate, prefill_and_caches

__all__ = ["greedy_generate", "prefill_and_caches", "decode_loop",
           "ContinuousBatchingEngine", "SamplingParams", "Request"]
