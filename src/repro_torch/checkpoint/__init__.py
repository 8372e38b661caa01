"""Atomic, content-addressed checkpoints (the reference's ``repro/checkpoint``),
in the reference's on-disk layout: a checkpoint written by either package
loads in the other."""
from .store import CheckpointStore, save_checkpoint, load_checkpoint, latest_step

__all__ = ["CheckpointStore", "save_checkpoint", "load_checkpoint",
           "latest_step"]
