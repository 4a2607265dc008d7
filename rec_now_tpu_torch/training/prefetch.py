"""Host-side input prefetching on worker threads.

Counterpart of ``rec_now_tpu/training/prefetch.py``: a worker thread
pulls host batches (or packs windows) and places them on the device while
the loop thread dispatches steps, through a bounded queue.  The placement
function is the trainer's (``Trainer.put`` or
``Trainer.put_packed_window``), which on the card copies on a side
stream from pinned memory and returns once its copy has landed, so the
worker, not the loop, waits for it.  An exception raised on a worker
reaches the loop where it iterates.  Live prefetchers are closed at
interpreter exit in creation order (a window prefetcher's parse stage
before its packing stage, whose worker may wait on the parse stage's
queue).

Example:
    with WindowPrefetcher(data.batches(8192, 100),
                          trainer.put_packed_window, window=5) as wins:
        for dev_win, n_steps in wins:
            state, metrics = trainer.train_many_packed(state, dev_win)
"""
from __future__ import annotations

import atexit
import itertools
import logging
import queue
import threading
import time
import weakref
from typing import Callable, Iterable, Iterator, Optional

_END = object()
_LIVE: "weakref.WeakSet" = weakref.WeakSet()
_SEQ = itertools.count()


@atexit.register
def _shutdown_all_prefetchers() -> None:
    # creation order: a WindowPrefetcher's packing worker may block in
    # get() on its parse stage's queue, so the parse stage (created first)
    # closes first and its _END wakes the packing worker
    for p in sorted(_LIVE, key=lambda p: getattr(p, "_seq", 0)):
        try:
            p.close()
        except Exception:
            pass


class DevicePrefetcher:
    """Iterate device-ready batches produced ahead on a worker thread.

    Args:
        batches: host-batch iterable.
        put: host -> device placement (``trainer.put``), run on the worker.
        depth: batches staged ahead (2 = double buffering).
    """

    def __init__(self, batches: Iterable, put: Callable, depth: int = 2):
        if depth < 1:
            raise ValueError("depth must be >= 1")
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()

        def worker():
            try:
                for b in batches:
                    if self._stop.is_set():
                        return
                    self._q.put(put(b))
            except BaseException as e:  # re-raised on the consumer side
                self._err = e
            finally:
                self._q.put(_END)

        self._seq = next(_SEQ)
        self._thread = threading.Thread(target=worker, daemon=True,
                                        name="rec_now_tpu_torch-prefetch")
        self._thread.start()
        _LIVE.add(self)

    def __iter__(self) -> Iterator:
        while True:
            item = self._q.get()
            if item is _END:
                if self._err is not None:
                    raise self._err
                return
            yield item

    def close(self, timeout: float = 5.0) -> None:
        """Stop the producer and drain, bounded by ``timeout``; leaves one
        ``_END`` in the queue so another consumer blocked in ``get()``
        wakes up."""
        self._stop.set()
        deadline = time.monotonic() + timeout
        while self._thread.is_alive() and time.monotonic() < deadline:
            try:
                self._q.get(timeout=0.05)   # unblocks a full-queue put
            except queue.Empty:
                pass
        self._thread.join(timeout=0.2)
        if self._thread.is_alive():
            logging.getLogger(__name__).warning(
                "prefetch worker %s did not exit within %.1f s; leaking "
                "daemon thread", self._thread.name, timeout)
        while True:                          # drain leftovers
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        try:
            self._q.put_nowait(_END)         # wake any other consumer
        except queue.Full:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class WindowPrefetcher:
    """Stage packed windows ahead of the windowed training loop.

    Yields ``(device_window, n_steps)``; the last window may be ragged.

    Args:
        batches: host-batch iterable.
        put_window: packs and places a list of host batches
            (``trainer.put_packed_window``); runs on the worker thread.
        window: steps per window.
        depth: windows staged ahead of the one being consumed.
        parse_ahead: pull the source iterator on a thread of its own too,
            so drawing batches and packing them overlap.
    """

    def __init__(self, batches: Iterable, put_window: Callable,
                 window: int, depth: int = 1, parse_ahead: bool = True):
        if window < 1:
            raise ValueError("window must be >= 1")
        self._parse_stage = None
        if parse_ahead:
            batches = self._parse_stage = DevicePrefetcher(
                batches, lambda b: b, depth=2 * window)

        def windows():
            buf = []
            for b in batches:
                buf.append(b)
                if len(buf) == window:
                    yield buf, window
                    buf = []
            if buf:
                yield buf, len(buf)

        self._inner = DevicePrefetcher(
            windows(), lambda wn: (put_window(wn[0]), wn[1]), depth=depth)

    def __iter__(self) -> Iterator:
        return iter(self._inner)

    def close(self) -> None:
        # the parse stage first: its _END unblocks the packing worker
        if self._parse_stage is not None:
            self._parse_stage.close()
        self._inner.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
