"""Optional wandb integration (the reference's pattern:
training_nli_v2.py:74-77 init/config, SentenceTransformer.py:817-818 loss logs).

wandb is not a dependency; `make_wandb_log_fn` returns None when unavailable so
callers can do `log_fn=make_wandb_log_fn(...) or my_fallback`.

The port's own copy of `sgpt_tpu/utils/wandb_logger.py`, with the same
behaviour: the port imports nothing of the JAX package.
"""
from __future__ import annotations

import logging
from typing import Callable, Optional

logger = logging.getLogger(__name__)


def make_wandb_log_fn(project: str, config: Optional[dict] = None,
                      name: Optional[str] = None) -> Optional[Callable[[dict], None]]:
    """TrainConfig.log_fn backed by wandb.log, or None if wandb is missing."""
    try:
        import wandb
    except ImportError:
        logger.info("wandb not installed; metrics stay in the local history")
        return None
    run = wandb.init(project=project, config=config or {}, name=name)

    def log_fn(record: dict):
        step = record.get("step")
        payload = {k: v for k, v in record.items() if k != "step"}
        run.log(payload, step=step)

    return log_fn
