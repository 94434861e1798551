"""Host-side ReduceLROnPlateau, torch-semantics-compatible.

The reference steps torch's ``ReduceLROnPlateau(mode="min", factor, patience)``
on the epoch validation loss (train.py:52-57,243). The schedule is inherently
stateful host logic (one decision per epoch); the train loop writes the
current LR into the optimizer's parameter groups (a copy of
``sola_tpu/train/schedule.py``).

torch semantics reproduced: rel-threshold 1e-4 improvement test, LR is
multiplied by ``factor`` after ``patience`` consecutive non-improving epochs
(i.e. on the (patience+1)-th bad epoch), ``min_lr`` floor, optional cooldown.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class ReduceLROnPlateau:
    lr: float
    factor: float = 0.5
    patience: int = 5
    threshold: float = 1e-4
    min_lr: float = 0.0
    cooldown: int = 0

    best: float = float("inf")
    num_bad_epochs: int = 0
    cooldown_counter: int = 0

    def step(self, metric: float) -> float:
        """Record an epoch metric; returns the (possibly reduced) LR."""
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.num_bad_epochs = 0
        elif self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
            if self.num_bad_epochs > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.num_bad_epochs = 0
                self.cooldown_counter = self.cooldown
        return self.lr

    def state_dict(self) -> dict:
        return dataclasses.asdict(self)

    def load_state_dict(self, state: dict) -> None:
        for k, v in state.items():
            setattr(self, k, v)
