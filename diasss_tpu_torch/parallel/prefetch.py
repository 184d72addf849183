"""Pipeline overlap of host work with device work.

The port's copy of :func:`diasss_tpu.parallel.prefetch.prefetch_iter`, which
:meth:`diasss_tpu_torch.online.OnlineSlam.run_stream` uses: a background
thread runs each thunk's host work (file parse, numpy assembly) for the
next items while the consumer thread does the device work of the current
one.  Thunks return host arrays; every CUDA call stays on the consumer
thread.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, List

_SENTINEL = object()


def prefetch_iter(thunks: Iterable[Callable[[], object]], depth: int = 2) -> Iterator[object]:
    """Yield ``thunk()`` results with a background producer thread.

    The producer runs at most ``depth`` items ahead of the consumer.  Thunks
    should do host-side work only (IO, numpy); device calls belong on the
    consumer side.  An exception in a thunk is re-raised in the consumer.
    """
    q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
    err: List[BaseException] = []
    stop = threading.Event()  # set when the consumer abandons the generator

    def _put(item) -> bool:
        # timeout-put so an abandoned consumer (generator closed with a full
        # queue) cannot block the producer forever holding file handles open
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for t in thunks:
                if stop.is_set() or not _put(t()):
                    return
        except BaseException as e:  # noqa: BLE001 — re-raised on the consumer
            err.append(e)
        finally:
            _put(_SENTINEL)

    th = threading.Thread(target=producer, daemon=True)
    th.start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                break
            yield item
    finally:
        # reached on normal exhaustion and on early close or throw from the
        # consumer: release the producer promptly
        stop.set()
        th.join()
    if err:
        raise err[0]
