"""Early stopping on a monitored metric (a copy of
``facerec_tpu/train/early_stopping.py``, pure Python)."""

from __future__ import annotations

import math


class EarlyStopping:
    def __init__(self, patience: int = 10, min_delta: float = 0.0, mode: str = "min", trace: bool = False):
        assert mode in ("min", "max")
        self.patience = patience
        self.min_delta = min_delta
        self.mode = mode
        self.trace = trace
        self.best = math.inf if mode == "min" else -math.inf
        self.counter = 0
        self.should_stop = False
        self.history: list[dict] = []

    def __call__(self, value: float) -> bool:
        improved = (value < self.best - self.min_delta) if self.mode == "min" else (value > self.best + self.min_delta)
        if improved:
            self.best = value
            self.counter = 0
        else:
            self.counter += 1
            if self.counter >= self.patience:
                self.should_stop = True
        if self.trace:
            self.history.append({"value": float(value), "best": float(self.best),
                                 "counter": self.counter, "stop": self.should_stop})
        return self.should_stop

    def state_dict(self) -> dict:
        return {"best": self.best, "counter": self.counter,
                "should_stop": self.should_stop, "history": list(self.history)}

    def load_state_dict(self, d: dict) -> None:
        self.best = float(d["best"])
        self.counter = int(d["counter"])
        self.should_stop = bool(d["should_stop"])
        self.history = list(d.get("history", []))
