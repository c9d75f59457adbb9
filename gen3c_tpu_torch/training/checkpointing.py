"""Asynchronous training checkpoints with ``torch.save`` (the port's
counterpart of gen3c_tpu/training/checkpointing.py, which uses orbax).

A save copies the state to host memory on the caller's thread, then writes
``<dir>/step_<n>.pt`` on a background thread (first to a temporary name,
then renamed, so a reader never sees half a file); ``wait()`` joins it. At
most ``max_to_keep`` checkpoints stay. The files are the port's own, not
orbax's.
"""

from __future__ import annotations

import os
import re
import threading
from typing import Any, List, Optional

import torch

from gen3c_tpu_torch.utils import log

_NAME = re.compile(r"^step_(\d+)\.pt$")


def _to_host(obj: Any) -> Any:
    if torch.is_tensor(obj):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    return obj


class Checkpointer:
    def __init__(self, ckpt_dir: str, max_to_keep: int = 3):
        self.ckpt_dir = os.path.abspath(ckpt_dir)
        self.max_to_keep = max_to_keep
        os.makedirs(self.ckpt_dir, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def steps(self) -> List[int]:
        """Steps with a finished checkpoint, ascending."""
        found = (_NAME.match(f) for f in os.listdir(self.ckpt_dir))
        return sorted(int(m.group(1)) for m in found if m)

    @property
    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def _path(self, step: int) -> str:
        return os.path.join(self.ckpt_dir, f"step_{step}.pt")

    def save(self, step: int, state_dict: dict, copy: bool = True) -> None:
        """Copy ``state_dict`` to the host now (copy False: it is a host
        copy of its own already, written as it is); write it in the
        background."""
        self.wait()
        host = _to_host(state_dict) if copy else state_dict

        def write():
            try:
                tmp = self._path(step) + ".tmp"
                torch.save(host, tmp)
                os.replace(tmp, self._path(step))
                for old in self.steps()[:-self.max_to_keep]:
                    os.remove(self._path(old))
            except BaseException as e:  # noqa: BLE001 - re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=write, name=f"ckpt-{step}", daemon=True)
        self._thread.start()
        log.info(f"checkpoint save dispatched at step {step}")

    def restore(self, step: Optional[int] = None) -> Optional[dict]:
        """The host state dict of ``step`` (default: the latest), or None."""
        self.wait()
        step = self.latest_step if step is None else step
        if step is None:
            return None
        sd = torch.load(self._path(step), map_location="cpu", weights_only=True)
        log.info(f"restored checkpoint step {step}")
        return sd

    def wait(self) -> None:
        """Join the pending write; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
