"""Host-side prefetch queue: the data-provider thread of the pipeline.

Port of kimera_vio_tpu/utils/prefetch.py. The reference overlaps dataset
IO with compute by running the data provider on its own thread, pushing
into bounded ThreadsafeQueues (utils/ThreadsafeQueue.h, Pipeline.cpp:318
pushBlockingIfFull(5)). Here one background thread decodes images ahead
of the consumer and hands packets through a bounded queue, backpressure
included (the worker blocks while the queue is full). A worker's
exception is raised in the consumer. `close()` ends the worker when the
consumer stops early (a backend-health stop), so no thread is left
blocked on a full queue.
"""

from __future__ import annotations

import queue
import threading


class PrefetchIterator:
    """Wraps a packet iterator; `transform` runs on the worker thread
    (image decode and any host preprocessing)."""

    _DONE = object()

    def __init__(self, iterator, transform, depth: int = 4):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._exc: BaseException | None = None

        def put(item) -> bool:
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    continue
            return False

        def work():
            try:
                for item in iterator:
                    if not put(transform(item)):
                        return
            except BaseException as e:  # noqa: BLE001 - re-raised in the consumer
                self._exc = e
            finally:
                put(self._DONE)

        self._thread = threading.Thread(target=work, name="kimera-prefetch", daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._DONE:
            self._thread.join()
            if self._exc is not None:
                raise self._exc
            raise StopIteration
        return item

    def close(self, timeout: float = 10.0) -> None:
        """Stop the worker and wait for it to end."""
        self._stop.set()
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise RuntimeError("prefetch worker did not end")
