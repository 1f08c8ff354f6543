"""Host-side streaming utilities for the out-of-core engines.

`Prefetcher` runs the user's batch producer on a background thread into a
bounded queue, so disk reads / mmap page faults / CSV parsing overlap the
device compute and the host->device transfers of the PREVIOUS batch.
JAX dispatch is already asynchronous, but the producer itself (e.g.
MmapDataset.gather page-faulting through a cold file) is synchronous
Python — without a reader thread it serializes with the h2d put of the
batch it just produced.

The queue is bounded (default 2 groups) so a fast producer cannot fill
host RAM with decoded batches.
"""

import queue
import threading

__all__ = ['Prefetcher']

_SENTINEL = object()


class Prefetcher:
    """Iterate `producer(i) for i in range(n)` on a background thread.

    Exceptions in the producer are re-raised in the consumer at the next
    `get()` — never swallowed. Always `close()` (or use as a context
    manager) to join the thread; abandoning mid-stream is safe (the
    bounded queue blocks the producer, close() drains and joins).
    """

    def __init__(self, producer, n, depth=2):
        self._q = queue.Queue(maxsize=max(1, depth))
        self._err = None
        self._stop = threading.Event()
        self._n = n

        def run():
            try:
                for i in range(n):
                    if self._stop.is_set():
                        return
                    item = producer(i)
                    while not self._stop.is_set():
                        try:
                            self._q.put(item, timeout=0.1)
                            break
                        except queue.Full:
                            continue
            except BaseException as e:   # noqa: BLE001 — re-raised in get()
                self._err = e
            finally:
                while not self._stop.is_set():
                    try:
                        self._q.put(_SENTINEL, timeout=0.1)
                        break
                    except queue.Full:
                        continue

        self._t = threading.Thread(target=run, daemon=True)
        self._t.start()

    def get(self):
        """Next item, or raises StopIteration / the producer's error."""
        item = self._q.get()
        if item is _SENTINEL:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item

    def __iter__(self):
        while True:
            try:
                yield self.get()
            except StopIteration:
                return

    def close(self):
        self._stop.set()
        # drain so a blocked producer can observe the stop flag
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._t.join(timeout=5.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
