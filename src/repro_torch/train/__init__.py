"""Training on one card: AdamW (ZeRO-0/1 layouts), gradients, the DP
reductions and the train step — the counterparts of ``repro.train`` at
tp = 1, data parallelism on the stacked team."""
from .optimizer import AdamWConfig, adamw_init, adamw_update
from .step import (init_train_state, make_train_step, state_from_tree,
                   state_to_tree)

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "init_train_state",
           "make_train_step", "state_to_tree", "state_from_tree"]
