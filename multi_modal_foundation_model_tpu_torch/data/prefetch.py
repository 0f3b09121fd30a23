"""Background host->device batch prefetching.

Port of ``multi_modal_foundation_model_tpu/data/prefetch.py``
(``DevicePrefetcher``, :29). For splits too large to keep on the card
(``device_resident_data`` covers the single-session case), a per-batch
copy otherwise serialises with compute. A daemon thread pulls items from
the host iterator and places them, keeping up to ``depth`` placed items
queued so the copies overlap the steps before them.

On the card (``device`` a CUDA device), placement runs on a side stream:
``pinned_batch_placer`` copies each array into pinned host memory and on to
the card with ``non_blocking=True``, and the producer records an event
behind the copies. The consumer's ``__next__`` makes the current stream
wait on that event and calls ``record_stream`` on every tensor of the
item, so the caching allocator does not hand their memory to another
stream's work before the consumer's has run. On the CPU, placement is a
plain call.

Exceptions from the producer re-raise in the consumer at the failing
position. An abandoned iterator does not strand the producer: puts poll a
stop event, which ``close()`` (also called by ``__del__``) sets, so the
thread exits and drops its queued batches.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterable, Iterator, Optional, Sequence

import numpy as np
import torch

_SENTINEL = object()


def _tensors(item) -> Iterator[torch.Tensor]:
    """The tensors of a placed item (a tensor, or a dict / list / tuple of
    them)."""
    if isinstance(item, torch.Tensor):
        yield item
    elif isinstance(item, dict):
        for v in item.values():
            yield from _tensors(v)
    elif isinstance(item, (list, tuple)):
        for v in item:
            yield from _tensors(v)


class DevicePrefetcher:
    """Iterate ``place(item)`` for items of ``it``, with placement running
    ``depth`` items ahead on a daemon thread (on a side stream of
    ``device`` when it is a CUDA device)."""

    def __init__(self, it: Iterable, place: Callable, depth: int = 2,
                 device=None):
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()
        self._finished = False
        dev = torch.device(device) if device is not None else None
        self._cuda = dev is not None and dev.type == "cuda"
        side = torch.cuda.Stream(dev) if self._cuda else None

        def put(item) -> bool:
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def placed(item):
            if not self._cuda:
                return place(item), None
            with torch.cuda.stream(side):
                out = place(item)
                done = torch.cuda.Event()
                done.record(side)
            return out, done

        def run():
            try:
                for item in it:
                    if not put(placed(item)):
                        return          # consumer gone; drop remainder
            except BaseException as e:  # noqa: BLE001 - re-raised on consume
                self._err = e
            finally:
                put(_SENTINEL)

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def close(self) -> None:
        """Release the producer thread (safe to call more than once)."""
        self._stop.set()
        self._finished = True

    def __del__(self):
        self._stop.set()

    def __iter__(self) -> "DevicePrefetcher":
        return self

    def __next__(self):
        if self._finished:
            raise StopIteration
        item = self._q.get()
        if item is _SENTINEL:
            self._finished = True
            self._thread.join()
            if self._err is not None:
                raise self._err
            raise StopIteration
        out, done = item
        if done is not None:
            stream = torch.cuda.current_stream()
            stream.wait_event(done)
            for t in _tensors(out):
                t.record_stream(stream)
        return out


def pinned_batch_placer(keys: Sequence[str], device
                        ) -> Callable[[Dict[str, np.ndarray]],
                                      Dict[str, torch.Tensor]]:
    """A ``place`` for ``DevicePrefetcher``: the ``keys`` of a host batch,
    each copied into pinned memory and on to ``device`` without blocking
    (on the producer's side stream)."""
    dev = torch.device(device)

    def place(batch):
        out = {}
        for k in keys:
            host = torch.as_tensor(batch[k])
            if dev.type == "cuda":
                host = host.pin_memory()
            out[k] = host.to(dev, non_blocking=True)
        return out
    return place
