"""What the benchmark reads from the program's first steps for the check.

The weights are drawn by the benchmark (``gen.draw_weights``) and loaded
through the model's state dict. A forward hook keeps each checked step's
logits (and, where asked, its input features); after the first step the
gradient is worked out from AdamW's state, ``exp_avg / (1 − β1)``: the
gradient as the optimizer got it; after the last checked step the
parameters are copied before the next step moves them. ``snapshot``
copies them at any time (before and after the window).
"""

from __future__ import annotations

import torch

from custom_op_benchmark_tpu_torch.train.loop import create_train_state
from gnnbench import gen


def load_weights(model: torch.nn.Module, seed: int, device) -> dict:
    """Draw the model's weights from ``seed`` on ``device`` and load them;
    returns them (the reference starts from the same)."""
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    weights = gen.draw_weights(shapes, seed, device)
    model.load_state_dict(weights)
    return weights


def start(cfg: dict, family, seed: int, device, steps: int,
          keep_inputs: bool = False) -> tuple:
    """The port's model for ``cfg`` with the benchmark's weights, its train
    state (``create_train_state``) and a capture of its first ``steps``
    steps: ``(state, weights, capture)``."""
    model = family.build(cfg["model"], device)
    weights = load_weights(model, seed, device)
    opt = cfg["optimizer"]
    state = create_train_state(model, learning_rate=opt["learning_rate"],
                               weight_decay=opt["weight_decay"])
    return state, weights, Capture(model, state.optimizer, steps,
                                   keep_inputs)


class Capture:
    """Reads the first ``steps`` steps of ``model`` under ``optimizer``."""

    def __init__(self, model, optimizer, steps: int, keep_inputs=False):
        self.model, self.optimizer, self.steps = model, optimizer, steps
        self.keep_inputs = keep_inputs
        self.logits, self.inputs, self.losses = [], [], []
        self.grad1 = self.params = None
        self._hook = model.register_forward_hook(self._read)

    def _read(self, module, args, out):
        self.logits.append(out.detach().clone())
        if self.keep_inputs:
            self.inputs.append(args[1].detach())

    def after_step(self, loss: torch.Tensor) -> None:
        """Call after each checked step with its loss."""
        self.losses.append(loss.detach())
        names = dict(self.model.named_parameters())
        if len(self.losses) == 1:
            beta1 = self.optimizer.param_groups[0]["betas"][0]
            self.grad1 = {}
            for k, p in names.items():
                st = self.optimizer.state.get(p, {})
                m = st.get("exp_avg")
                self.grad1[k] = (torch.zeros_like(p) if m is None
                                 else m.detach() / (1 - beta1))
        if len(self.losses) == self.steps:
            self.params = {k: p.detach().clone() for k, p in names.items()}
            self._hook.remove()

    def snapshot(self) -> dict:
        """A copy of the model's parameters as they stand."""
        return {k: p.detach().clone()
                for k, p in self.model.named_parameters()}

    def record(self) -> dict:
        return dict(losses=[float(x) for x in self.losses],
                    logits=self.logits, grad1=self.grad1,
                    params=self.params, inputs=self.inputs)
