"""Host-side prefetching for the streamed input path (the port's copy of
``percivaltts_tpu/utils/prefetch.py``).

The reference's batch generator produces batches strictly on demand
(percivaltts/data.py); here a small background thread keeps a bounded queue
of prepared batches, so host-side assembly, casting and pinning overlap the
device's work.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, TypeVar

T = TypeVar("T")

_SENTINEL = object()


class _PrefetchError:
    """Typed error envelope — a dedicated class so no legitimate item the
    iterable could yield (tuples, arrays, …) can ever be mistaken for it."""

    def __init__(self, exc: BaseException):
        self.exc = exc


def prefetch(iterable: Iterable[T], depth: int = 2) -> Iterator[T]:
    """Iterate ``iterable`` through a ``depth``-deep background queue.

    Exceptions in the producer propagate to the consumer; the producer
    thread is a daemon so an abandoned iterator can't hang interpreter
    shutdown.
    """
    q: "queue.Queue" = queue.Queue(maxsize=depth)

    def producer():
        try:
            for item in iterable:
                q.put(item)
        except BaseException as e:  # propagate into the consumer
            q.put(_PrefetchError(e))
        finally:
            q.put(_SENTINEL)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is _SENTINEL:
            break
        if isinstance(item, _PrefetchError):
            raise item.exc
        yield item
