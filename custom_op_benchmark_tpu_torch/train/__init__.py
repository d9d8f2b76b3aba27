"""Training loops, checkpoints and the resilient step driver."""

from custom_op_benchmark_tpu_torch.train.checkpoint import (
    restore_checkpoint,
    save_checkpoint,
)
from custom_op_benchmark_tpu_torch.train.loop import (
    TrainState,
    create_train_state,
    fit_full_graph,
    fit_sampled,
    fit_sampled_dp,
    make_eval_step,
    make_sampled_step,
    make_train_step,
    masked_cross_entropy,
)
from custom_op_benchmark_tpu_torch.train.resilient import (
    CheckpointManager,
    DivergenceError,
    resilient_steps,
)

__all__ = ["CheckpointManager", "DivergenceError", "TrainState",
           "create_train_state", "fit_full_graph", "fit_sampled",
           "fit_sampled_dp",
           "make_eval_step", "make_sampled_step", "make_train_step",
           "masked_cross_entropy", "resilient_steps", "restore_checkpoint",
           "save_checkpoint"]
