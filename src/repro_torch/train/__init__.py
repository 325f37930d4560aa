"""repro_torch.train — training on one device: AdamW and its schedules,
the microbatched train step and the rescaler fine-tune (``distill``).
``make_compressed_step`` is the multi-device slice's (ROADMAP item 11) and
raises."""
from .optimizer import (AdamWConfig, AdamWState, adamw_init, adamw_update,
                        cosine_schedule, global_norm, wsd_schedule)
from .train_loop import (TrainState, init_train_state, make_compressed_step,
                         make_train_step, microbatch_grads)

__all__ = ["AdamWConfig", "AdamWState", "adamw_init", "adamw_update",
           "cosine_schedule", "global_norm", "wsd_schedule", "TrainState",
           "init_train_state", "make_compressed_step", "make_train_step",
           "microbatch_grads"]
