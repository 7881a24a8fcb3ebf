"""Background-thread prefetch over an iterator with a bounded queue (the
host half of double buffering; the JAX package's
``data.video_io.Prefetcher``, plus ``close``)."""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional


class Prefetcher:
    """Runs ``it`` on a daemon thread, at most ``depth`` items ahead; an
    exception in the producer is raised in the consumer.  ``close()``
    stops the thread (an endless producer otherwise keeps making items
    until the queue is full) and then closes ``it``; after it the
    iterator yields what is already queued, then ends."""

    _DONE = object()

    def __init__(self, it: Iterator, depth: int = 2):
        self._it = it
        self._q: queue.Queue = queue.Queue(maxsize=max(depth, 1))
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()

        def put(item) -> bool:
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def worker():
            try:
                for item in it:
                    if not put(item):
                        return
            except BaseException as e:  # propagate to consumer
                self._err = e
            finally:
                put(self._DONE)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        while True:
            try:
                item = self._q.get(timeout=0.1)
                break
            except queue.Empty:
                # after close() the producer queues nothing more
                if self._stop.is_set():
                    raise StopIteration from None
        if item is self._DONE:
            self._q.put(self._DONE)  # later calls end too
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item

    def close(self, timeout: float = 10.0) -> None:
        """Stop the producer thread and wait for it (at most ``timeout``
        seconds beyond the item it is making); then close the producer
        when it is a generator, so its ``finally`` and ``with`` blocks
        run (e.g. a worker pool shuts down)."""
        self._stop.set()
        self._thread.join(timeout)
        if not self._thread.is_alive() and hasattr(self._it, "close"):
            self._it.close()
