from .bitfit import BIAS_NAMES, bitfit_mask, trainable_count
from .checkpoint import load_checkpoint, prune_checkpoints, save_checkpoint
from .gradcache import chunk_tree, gradcache_backward
from .schedules import make_schedule, warmup_linear
from .trainer import ContrastiveTrainer, TrainConfig
from .tsdae import TSDAETrainer, init_tsdae_params, tsdae_loss

__all__ = [
    "BIAS_NAMES", "bitfit_mask", "trainable_count",
    "chunk_tree", "gradcache_backward",
    "make_schedule", "warmup_linear",
    "ContrastiveTrainer", "TrainConfig",
    "save_checkpoint", "load_checkpoint", "prune_checkpoints",
    "TSDAETrainer", "tsdae_loss", "init_tsdae_params",
]
