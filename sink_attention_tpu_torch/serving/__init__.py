from .engine import ContinuousBatchingEngine, Request, SamplingParams
from .generate import (beam_generate, decode_loop, greedy_generate,
                       prefill_and_caches, speculative_generate)
from .sharded import make_sharded_generate

__all__ = ["greedy_generate", "beam_generate", "speculative_generate",
           "prefill_and_caches", "decode_loop", "ContinuousBatchingEngine",
           "SamplingParams", "Request", "make_sharded_generate"]
