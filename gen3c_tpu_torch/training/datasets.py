"""Training data helpers (the part of gen3c_tpu/training/datasets.py the
port needs so far; that module imports jax.numpy, so this is a port, not
an import). ``Gen3CClipDataset`` is not ported yet."""

from __future__ import annotations

import queue
import threading


class PrefetchIterator:
    """Background-thread batch prefetcher: the wrapped iterator runs in a
    worker thread while the training step executes, behind a bounded queue
    (double buffering by default). Exceptions reach the consumer; close()
    (or garbage collection) stops the worker."""

    _SENTINEL = object()

    def __init__(self, iterable, prefetch: int = 2):
        self._q = queue.Queue(maxsize=max(1, prefetch))
        self._err = None
        self._stop = threading.Event()

        def worker():
            try:
                for item in iterable:
                    if self._stop.is_set():
                        return
                    self._q.put(item)
            except BaseException as e:  # noqa: BLE001 - re-raised in __next__
                self._err = e
            finally:
                self._q.put(self._SENTINEL)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._SENTINEL:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item

    def close(self):
        self._stop.set()
        # drain so a blocked put() wakes up and sees the stop flag
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass

    def __del__(self):
        self.close()
