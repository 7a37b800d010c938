"""repro_torch.train — AdamW, the train-step builder, cross-pod gradient
compression and checkpointing; mirrors ``src/repro/train``."""
from .checkpoint import AsyncCheckpointer, gc_old, latest, load, save
from .compression import compress_grads, compression_ratio, ef_init
from .optimizer import (OptConfig, adamw_init, adamw_update,
                        clip_by_global_norm, global_norm, schedule_lr)
from .step import (TrainConfig, abstract_train_state, build_train_step,
                   make_train_state, shard_train_state, state_shardings)

__all__ = ["AsyncCheckpointer", "gc_old", "latest", "load", "save",
           "compress_grads", "compression_ratio", "ef_init",
           "OptConfig", "adamw_init", "adamw_update", "clip_by_global_norm",
           "global_norm", "schedule_lr", "TrainConfig", "abstract_train_state",
           "build_train_step", "make_train_state", "shard_train_state",
           "state_shardings"]
