"""repro_torch.train — AdamW, the train-step builder and checkpointing;
mirrors ``src/repro/train`` without gradient compression."""
from .checkpoint import AsyncCheckpointer, gc_old, latest, load, save
from .optimizer import (OptConfig, adamw_init, adamw_update,
                        clip_by_global_norm, global_norm, schedule_lr)
from .step import TrainConfig, build_train_step, make_train_state

__all__ = ["AsyncCheckpointer", "gc_old", "latest", "load", "save",
           "OptConfig", "adamw_init", "adamw_update", "clip_by_global_norm",
           "global_norm", "schedule_lr", "TrainConfig", "build_train_step",
           "make_train_state"]
