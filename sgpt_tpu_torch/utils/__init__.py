"""Host utilities (counterpart of `sgpt_tpu/utils`): the thread-pool
DataFrame map and the text helpers of the API baselines, timing and
throughput counters, the torch.profiler trace, the optional wandb logger."""
from .parallelizer import DataFrameParallelizer, ErrorHandling, BatchError, retry
from .io_utils import clean_empty_list, unique_list, truncate_text_list, generate_unique
from .profiling import Timer, ThroughputMeter, profile_trace

__all__ = [
    "DataFrameParallelizer", "ErrorHandling", "BatchError", "retry",
    "clean_empty_list", "unique_list", "truncate_text_list", "generate_unique",
    "Timer", "ThroughputMeter", "profile_trace",
]
