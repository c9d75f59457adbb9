"""Wall-clock timing of device work: a synchronise that is a no-op on the
CPU, and ``Laps``, the seconds between synchronised points."""

from __future__ import annotations

import time
from typing import Optional

import torch


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Laps:
    """Seconds between synchronised points into ``record``: ``lap(key)``
    appends the time since the last ``start`` or lap to record[key]. A no-op
    without a record, so that untimed runs never synchronise."""

    def __init__(self, device: torch.device, record: Optional[dict]):
        self.device, self.record, self.t = device, record, 0.0
        self.start()

    def start(self) -> None:
        if self.record is not None:
            synchronize(self.device)
            self.t = time.perf_counter()

    def lap(self, key: str) -> None:
        if self.record is not None:
            t = self.t
            self.start()
            self.record.setdefault(key, []).append(self.t - t)
