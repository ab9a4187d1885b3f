"""Host utilities (counterpart of `sgpt_tpu/utils`): the thread-pool
DataFrame map and the text helpers of the API baselines, timing, the
program's profiler spans and the torch.profiler trace, the optional wandb
logger."""
from .parallelizer import DataFrameParallelizer, ErrorHandling, BatchError, retry
from .io_utils import clean_empty_list, unique_list, truncate_text_list, generate_unique
from .profiling import Timer, profile_trace, span

__all__ = [
    "DataFrameParallelizer", "ErrorHandling", "BatchError", "retry",
    "clean_empty_list", "unique_list", "truncate_text_list", "generate_unique",
    "Timer", "profile_trace", "span",
]
