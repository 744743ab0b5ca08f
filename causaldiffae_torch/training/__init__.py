"""Training: samplers, state, the train step, checkpoints and the host loop."""

from .checkpoint import CheckpointManager
from .loop import run_training
from .samplers import init_sampler_state, sample_timesteps, update_sampler_state
from .state import TrainState, create_train_state, ema_rates, kl_weight_for_step, make_optimizer
from .train_step import make_train_step

__all__ = ["CheckpointManager", "run_training", "init_sampler_state", "sample_timesteps",
           "update_sampler_state", "TrainState", "create_train_state", "ema_rates", "kl_weight_for_step",
           "make_optimizer", "make_train_step"]
