from .device import resolve_device
from .timing import (H100_HBM_BW, H100_PEAK_BF16, H100_PEAK_FP32,
                     H100_PEAK_INT8, attention_pairs, card_line,
                     sink_attention_flops, time_cuda)

__all__ = ["resolve_device", "time_cuda", "card_line", "sink_attention_flops",
           "attention_pairs", "H100_PEAK_BF16", "H100_PEAK_INT8",
           "H100_PEAK_FP32", "H100_HBM_BW"]
