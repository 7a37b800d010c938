"""repro_torch.train — AdamW and the train-step builder; mirrors
``src/repro/train`` without checkpointing and gradient compression."""
from .optimizer import (OptConfig, adamw_init, adamw_update,
                        clip_by_global_norm, global_norm, schedule_lr)
from .step import TrainConfig, build_train_step, make_train_state

__all__ = ["OptConfig", "adamw_init", "adamw_update", "clip_by_global_norm",
           "global_norm", "schedule_lr", "TrainConfig", "build_train_step",
           "make_train_state"]
