from .ragged import RaggedSinkKVCache
from .sink_cache import QUANT_MAX, SinkKVCache, dequantize, quantize

__all__ = ["SinkKVCache", "RaggedSinkKVCache", "QUANT_MAX", "quantize",
           "dequantize"]
