"""Training substrate: optimizer (AdamW + WSD/cosine), the train step,
microbatching, elastic re-meshing and straggler policy."""
from repro_torch.training.optimizer import (AdamWConfig, adamw_init,
                                            adamw_update, lr_at)
from repro_torch.training.step import (TrainState, init_train_state,
                                       make_train_step)

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "lr_at",
           "TrainState", "make_train_step", "init_train_state"]
