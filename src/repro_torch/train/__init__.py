"""repro_torch.train — AdamW and its schedules, the microbatched train
step (data-parallel under a mesh of ranks), the compressed DP step with
the int8 error-feedback all-reduce (``grad_compress``) and the rescaler
fine-tune (``distill``)."""
from .optimizer import (AdamWConfig, AdamWState, adamw_init, adamw_update,
                        cosine_schedule, global_norm, wsd_schedule)
from .train_loop import (TrainState, init_train_state, make_compressed_step,
                         make_train_step, microbatch_grads)

__all__ = ["AdamWConfig", "AdamWState", "adamw_init", "adamw_update",
           "cosine_schedule", "global_norm", "wsd_schedule", "TrainState",
           "init_train_state", "make_compressed_step", "make_train_step",
           "microbatch_grads"]
