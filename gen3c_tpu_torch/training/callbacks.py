"""Training callbacks (port of the part of gen3c_tpu/training/callbacks.py
the trainer uses: the hook surface, its dispatch group, the speed logger
and the hung-step watchdog). That module logs through gen3c_tpu's logger,
so the port carries its own and never imports the JAX package.

The forward, backward and optimizer sub-hooks fire adjacently around the
one ``train_step`` call, in gen3c_tpu's order.
"""

from __future__ import annotations

import signal
import threading
import time
from typing import Any, Dict, List, Optional

from gen3c_tpu_torch.utils import log


class Callback:
    """The full hook surface; every hook does nothing by default."""

    def on_train_start(self, trainer) -> None: ...

    def on_before_dataloading(self, trainer, step: int) -> None: ...

    def on_after_dataloading(self, trainer, step: int, batch=None) -> None: ...

    def on_training_step_start(self, trainer, step: int) -> None: ...

    def on_before_forward(self, trainer, step: int) -> None: ...

    def on_after_forward(self, trainer, step: int) -> None: ...

    def on_before_backward(self, trainer, step: int) -> None: ...

    def on_after_backward(self, trainer, step: int) -> None: ...

    def on_before_optimizer_step(self, trainer, step: int) -> None: ...

    def on_before_zero_grad(self, trainer, step: int) -> None: ...

    def on_training_step_end(self, trainer, step: int, metrics: Dict[str, Any]) -> None: ...

    def on_validation_start(self, trainer, step: int) -> None: ...

    def on_validation_step_start(self, trainer, step: int) -> None: ...

    def on_validation_step_end(self, trainer, step: int, metrics=None) -> None: ...

    def on_validation_end(self, trainer, step: int, metrics) -> None: ...

    def on_load_checkpoint_start(self, trainer) -> None: ...

    def on_load_checkpoint_end(self, trainer, step: int = 0) -> None: ...

    def on_save_checkpoint_start(self, trainer, step: int = 0) -> None: ...

    def on_save_checkpoint_end(self, trainer, step: int = 0) -> None: ...

    def on_train_end(self, trainer) -> None: ...

    def on_app_end(self, trainer) -> None: ...


class CallBackGroup(Callback):
    """Calls each hook on every callback of the list, in order."""

    def __init__(self, callbacks: Optional[List[Callback]] = None):
        self.callbacks = callbacks or []

    def append(self, cb: Callback) -> None:
        self.callbacks.append(cb)

    def __getattribute__(self, name):
        if name.startswith("on_"):
            def dispatch(*args, **kwargs):
                for cb in object.__getattribute__(self, "callbacks"):
                    getattr(cb, name)(*args, **kwargs)

            return dispatch
        return object.__getattribute__(self, name)


class IterSpeed(Callback):
    """Log iterations per second (and the loss) every N steps."""

    def __init__(self, every_n: int = 10):
        self.every_n = every_n
        self._t0 = None
        self._last_step = 0

    def on_train_start(self, trainer):
        self._t0 = time.perf_counter()

    def on_training_step_end(self, trainer, step, metrics):
        if step % self.every_n == 0 and self._t0 is not None:
            dt = time.perf_counter() - self._t0
            loss = metrics.get("loss")
            log.info(f"step {step}: {(step - self._last_step) / max(dt, 1e-9):.2f} it/s"
                     + (f", loss {float(loss):.4f}" if loss is not None else ""))
            self._t0 = time.perf_counter()
            self._last_step = step


class StepTimeout(Exception):
    """A training step exceeded the watchdog's timeout."""


class HangWatchdog(Callback):
    """SIGALRM armed at every step start and cleared at its end: a step
    that blocks longer than ``timeout_s`` raises StepTimeout inside the
    blocked call instead of hanging the job. Saves and validation run
    disarmed. Signals reach only the main thread, so elsewhere it stays
    off (with a warning)."""

    def __init__(self, timeout_s: float = 1800.0):
        self.timeout_s = max(1, int(timeout_s))
        self._installed = False
        self._prev_handler = None

    def _handler(self, signum, frame):
        raise StepTimeout(f"training step exceeded {self.timeout_s}s watchdog")

    def on_train_start(self, trainer):
        if threading.current_thread() is not threading.main_thread():
            log.warning("HangWatchdog: not on the main thread; disabled")
            return
        self._prev_handler = signal.signal(signal.SIGALRM, self._handler)
        self._installed = True

    def on_training_step_start(self, trainer, step):
        if self._installed:
            signal.alarm(self.timeout_s)

    def on_training_step_end(self, trainer, step, metrics):
        if self._installed:
            signal.alarm(0)

    def on_train_end(self, trainer):
        if self._installed:
            signal.alarm(0)
            signal.signal(signal.SIGALRM, self._prev_handler)
            self._installed = False
