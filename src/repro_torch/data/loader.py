"""Background-prefetching loader (a copy of ``repro/data/loader.py``): a
bounded queue fed by a worker thread, so that host data generation overlaps
device compute."""
from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional


class PrefetchLoader:
    def __init__(self, batch_iter: Iterator, depth: int = 2):
        self._iter = batch_iter
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _fill(self):
        try:
            for item in self._iter:
                if self._stop.is_set():
                    return
                self._q.put(item)
        except BaseException as e:          # surfaced on next __next__
            self._err = e
        finally:
            self._q.put(None)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is None:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
