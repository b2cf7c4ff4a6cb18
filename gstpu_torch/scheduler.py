"""Learning-rate scheduling.

Port of ``gstpu/scheduler.py``: a class with the reference's API over the
same exponential decay as ``gstpu_torch.optim.exp_lr`` (which the train step
uses), in Python floats.
"""

from __future__ import annotations


class LRScheduler:
    """Exponential decay from ``initial_lr`` to ``initial_lr*final_lr_factor``."""

    def __init__(self, initial_lr: float, final_lr_factor: float = 0.01):
        self.initial_lr = initial_lr
        self.final_lr = initial_lr * final_lr_factor
        self._factor = final_lr_factor

    def get_lr(self, iteration: int, total_iterations: int) -> float:
        if total_iterations <= 1:
            return self.initial_lr
        progress = min(iteration / (total_iterations - 1), 1.0)
        return self.initial_lr * (self._factor ** progress)
