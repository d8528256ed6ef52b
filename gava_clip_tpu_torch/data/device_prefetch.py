"""Host-to-device prefetch: overlap the copy of batch N+1 with step N (port
of gava_clip_tpu/data/device_prefetch.py as a CUDA-stream prefetcher).

The train loop's natural order is load (host) -> copy (PCIe) -> step
(device). The loader's worker threads already overlap the load
(loader.py); this module takes the copy off the critical path too. A
background thread pulls host batches and runs `transfer` on a side CUDA
stream; `to_device_batch` stages each array in a reused pinned host buffer
and copies it with `non_blocking=True`, so the thread returns as soon as
the copies are queued. An event recorded after them travels with the
batch: the consumer makes its own stream wait on that event (no host sync)
and calls `record_stream` on every tensor, so that the caching allocator
does not hand the memory to the side stream again while the consumer's
kernels still read it.

On the CPU (`device` None or a CPU device) it is the same ordered
pass-through thread without streams, as in the JAX package.
"""

import queue
import threading
from typing import Callable, Dict, Iterable, Iterator, Optional, TypeVar

import numpy as np
import torch

T = TypeVar("T")
U = TypeVar("U")

_SENTINEL = object()


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


class PinnedBatchCopier:
    """batch (dict of numpy arrays; other values pass through) -> the same
    dict with tensors on `device`. On a CUDA device each array goes through
    a pinned host buffer, taken in turn from `slots` buffers per key and
    reused once the copy that last read it has finished, and the copy is
    asynchronous on the current stream. On the CPU it is
    `torch.from_numpy`."""

    def __init__(self, device, slots: int = 4):
        self.device = torch.device(device)
        self.slots = max(2, slots)
        self._ring: Dict = {}
        self._turn = 0

    def _staged(self, key, arr: np.ndarray) -> torch.Tensor:
        ring = self._ring.setdefault(
            (key, arr.shape, arr.dtype.str), [None] * self.slots)
        i = self._turn % self.slots
        if ring[i] is None:
            buf = torch.empty(arr.shape, dtype=torch.from_numpy(
                np.empty(0, arr.dtype)).dtype).pin_memory()
            ring[i] = [buf, None]
        buf, done = ring[i]
        if done is not None:
            done.synchronize()          # the copy that last read this buffer
        buf.numpy()[...] = arr
        out = buf.to(self.device, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        ring[i][1] = ev
        return out

    def __call__(self, batch: Dict) -> Dict:
        cuda = self.device.type == "cuda"
        out = {}
        for k, v in batch.items():
            if isinstance(v, np.ndarray):
                v = np.ascontiguousarray(v)
                out[k] = self._staged(k, v) if cuda else \
                    torch.from_numpy(v).to(self.device)
            else:
                out[k] = v
        self._turn += 1
        return out


def prefetch_to_device(iterator: Iterable[T], transfer: Callable[[T], U],
                       size: int = 2, device=None) -> Iterator[U]:
    """Yield transfer(item) for each item, transferring ahead of the
    consumer.

    `transfer` runs on a background thread and should QUEUE work
    (`non_blocking` copies) without waiting for it. With a CUDA `device` it
    runs under a side stream, and each yielded batch has been ordered
    before the consumer's current stream (event wait + `record_stream`).
    `size` bounds the read-ahead (device batches in flight); 2 hides one
    full copy behind one step.

    Exceptions raised by `transfer` or the source iterator are re-raised at
    the consumer's next `next()`. If the consumer abandons the generator
    early (preemption exit, test teardown), `close()` unblocks and joins
    the worker thread."""
    if size < 1:
        raise ValueError(f"prefetch size must be >= 1, got {size}")
    dev = None if device is None else torch.device(device)
    cuda = dev is not None and dev.type == "cuda"
    side: Optional["torch.cuda.Stream"] = \
        torch.cuda.Stream(device=dev) if cuda else None
    q: "queue.Queue" = queue.Queue(maxsize=size)
    stop = threading.Event()

    def _put(out) -> bool:
        """Queue `out`, however long the consumer's step takes; False once
        the consumer has stopped."""
        while not stop.is_set():
            try:
                q.put(out, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _worker():
        try:
            for item in iterator:
                if cuda:
                    with torch.cuda.stream(side):
                        out = transfer(item)
                        ready = torch.cuda.Event()
                        ready.record(side)
                    out = (out, ready)
                else:
                    out = (transfer(item), None)
                if not _put(out):
                    return
            _put(_SENTINEL)
        except BaseException as e:  # noqa: BLE001: surfaces at the consumer
            _put(e)

    t = threading.Thread(target=_worker, daemon=True, name="device-prefetch")
    t.start()
    try:
        while True:
            out = q.get()
            if out is _SENTINEL:
                break
            if isinstance(out, BaseException):
                raise out
            item, ready = out
            if ready is not None:
                cur = torch.cuda.current_stream(dev)
                cur.wait_event(ready)
                for x in _tensors(item):
                    if x.is_cuda:
                        x.record_stream(cur)
            yield item
    finally:
        stop.set()      # every put of the worker looks at it each 0.1 s
        t.join(timeout=5.0)
