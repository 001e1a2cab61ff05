"""Training substrate: native AdamW, microbatched train step, train state
(port of ``src/repro/train``)."""
from .optimizer import AdamW, AdamWState, global_norm, warmup_cosine
from .train_step import (TrainState, init_train_state, lm_loss, make_loss_fn,
                         make_train_step)

__all__ = [
    "AdamW", "AdamWState", "global_norm", "warmup_cosine",
    "TrainState", "init_train_state", "lm_loss", "make_loss_fn",
    "make_train_step",
]
