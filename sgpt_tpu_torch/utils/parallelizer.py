"""Thread-pool DataFrame map with batching, retries and error columns.

Host-side equivalent of the reference's `DataFrameParallelizer`
(biencoder/beir/parallelizer/parallelizer.py:71-311), used by the external-API
baseline paths (OpenAI embeddings benchmark). Pure host Python: no device
plays a role here; the shape of the tool is kept so those drivers port 1:1.

The port's own copy of `sgpt_tpu/utils/parallelizer.py`, with the same
behaviour (pandas imported only for a DataFrame): the port imports nothing of
the JAX package.
"""
from __future__ import annotations

import logging
import time
from concurrent.futures import ThreadPoolExecutor, as_completed
from enum import Enum
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

logger = logging.getLogger(__name__)


class ErrorHandling(Enum):
    LOG = "Log"
    FAIL = "Fail"


class BatchError(ValueError):
    """Raised when a batch function fails irrecoverably."""


def retry(exceptions: Tuple = (Exception,), tries: int = 3, delay: float = 1.0,
          backoff: float = 2.0):
    """Retry decorator with exponential backoff (the api path's @retry,
    beir_openai_embeddings_batched_parallel.py:192)."""

    def deco(fn: Callable):
        def wrapper(*args, **kw):
            wait = delay
            for attempt in range(tries):
                try:
                    return fn(*args, **kw)
                except exceptions as e:
                    if attempt == tries - 1:
                        raise
                    logger.warning("retry %d/%d after %s: %s", attempt + 1,
                                   tries, type(e).__name__, e)
                    time.sleep(wait)
                    wait *= backoff
        return wrapper

    return deco


class DataFrameParallelizer:
    """Apply `function` over rows (dicts) or batches of rows with a thread pool.

    run(rows) returns rows augmented with output/error columns:
        <prefix>_response, <prefix>_error_message, <prefix>_error_type
    Accepts a pandas DataFrame or a list of dicts; returns the same kind.
    """

    def __init__(self, function: Callable, *,
                 error_handling: ErrorHandling = ErrorHandling.LOG,
                 exceptions_to_catch: Tuple = (Exception,),
                 parallel_workers: int = 4,
                 batch_support: bool = False,
                 batch_size: int = 10,
                 output_column_prefix: str = "output",
                 batch_response_parser: Optional[Callable] = None):
        self.function = function
        self.error_handling = error_handling
        self.exceptions = exceptions_to_catch
        self.workers = parallel_workers
        self.batch_support = batch_support
        self.batch_size = batch_size
        self.prefix = output_column_prefix
        self.batch_response_parser = batch_response_parser or self._default_parser

    def _default_parser(self, batch: List[Dict], response: Sequence[Any]) -> List[Dict]:
        return [{**row, f"{self.prefix}_response": resp,
                 f"{self.prefix}_error_message": "",
                 f"{self.prefix}_error_type": ""}
                for row, resp in zip(batch, response)]

    def _error_rows(self, batch: List[Dict], err: Exception) -> List[Dict]:
        if self.error_handling == ErrorHandling.FAIL:
            raise err
        logger.warning("batch failed: %s: %s", type(err).__name__, err)
        return [{**row, f"{self.prefix}_response": None,
                 f"{self.prefix}_error_message": str(err),
                 f"{self.prefix}_error_type": type(err).__name__}
                for row in batch]

    def _call(self, batch: List[Dict]) -> List[Dict]:
        try:
            if self.batch_support:
                response = self.function(batch)
                return self.batch_response_parser(batch, response)
            assert len(batch) == 1
            return self._default_parser(batch, [self.function(batch[0])])
        except self.exceptions as e:
            return self._error_rows(batch, e)

    def run(self, df):
        is_pandas = hasattr(df, "to_dict") and hasattr(df, "columns")
        rows: List[Dict] = (df.to_dict(orient="records") if is_pandas else
                            [dict(r) for r in df])
        size = self.batch_size if self.batch_support else 1
        batches = [rows[i : i + size] for i in range(0, len(rows), size)]

        results: List[Optional[List[Dict]]] = [None] * len(batches)
        with ThreadPoolExecutor(max_workers=self.workers) as pool:
            futures = {pool.submit(self._call, b): i for i, b in enumerate(batches)}
            for fut in as_completed(futures):
                results[futures[fut]] = fut.result()
        out = [row for batch in results for row in (batch or [])]
        if is_pandas:
            import pandas as pd
            return pd.DataFrame(out)
        return out
