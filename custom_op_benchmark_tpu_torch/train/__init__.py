"""Training loops."""

from custom_op_benchmark_tpu_torch.train.loop import (
    TrainState,
    create_train_state,
    fit_full_graph,
    make_eval_step,
    make_train_step,
    masked_cross_entropy,
)

__all__ = ["TrainState", "create_train_state", "fit_full_graph",
           "make_eval_step", "make_train_step", "masked_cross_entropy"]
