"""Training on one card: AdamW (ZeRO-0/1 layouts), gradients and the
train step — the counterparts of ``repro.train`` at dp = tp = 1."""
from .optimizer import AdamWConfig, adamw_init, adamw_update
from .step import init_train_state, make_train_step

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "init_train_state",
           "make_train_step"]
