"""Optimizer of the training path: AdamW with f32 moments, learning-rate
schedules and gradient compression (the reference's ``repro/optim``)."""
from .adamw import AdamWConfig, adamw_init, adamw_step, global_norm
from .schedule import cosine_schedule, linear_warmup_cosine
from .compress import compress_grads, decompress_grads, CompressionConfig

__all__ = ["AdamWConfig", "adamw_init", "adamw_step", "global_norm",
           "cosine_schedule", "linear_warmup_cosine", "compress_grads",
           "decompress_grads", "CompressionConfig"]
