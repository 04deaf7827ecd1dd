"""Background-thread batch prefetching (the port of
gcnbmp_tpu/data/prefetch.py).

``PrefetchIterator`` keeps the JAX semantics: one producer thread runs the
upstream iterator ``depth`` items ahead of the consumer, an optional
``transfer`` runs on each item (on a pool of ``workers`` threads, order
kept), and any thread's exception is raised at the consumer, then
``StopIteration``.  The port adds what the card needs:

- ``device``: each producer and transfer thread enters it (the current
  CUDA device is per thread, and a multi-device rank's card is not card 0);
- ``close()`` (and ``with``): stops the producer, drains the queue, joins
  every thread and closes the upstream iterator, so that no thread stays
  blocked on a full queue when the consumer stops early or raises;
- ``PinnedRing``: the host side of every copy, a ring of pinned buffers
  allocated once and grown only for a larger item, copied ``non_blocking``
  on a side stream; a slot is rewritten only after the event recorded
  behind its last copy has completed, the device tensors are handed to the
  consumer's stream (``record_stream``), and ``Staged.get`` makes that
  stream wait on the copy's event, not the host.

A failed pin or copy raises at the consumer; nothing falls back to
pageable memory or to staging on the step's thread.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch


def _cuda_index(device) -> Optional[int]:
    """The card ``device`` names, ``cuda`` alone being the calling
    thread's current card; None off CUDA."""
    if device is None or torch.device(device).type != "cuda":
        return None
    index = torch.device(device).index
    return torch.cuda.current_device() if index is None else index


def _thread_device(device) -> Callable[[], None]:
    """What each prefetch thread runs first: make ``device`` (resolved on
    the calling thread) its current CUDA device, the current device being
    per thread; nothing on the CPU."""
    index = _cuda_index(device)
    if index is None:
        return lambda: None
    return lambda: torch.cuda.set_device(index)


class PrefetchIterator:
    """Wrap a batch iterator; stage ``depth`` batches ahead, transferring
    each through ``transfer`` when one is given.

    ``workers`` > 1 runs the transfers on a thread pool, their order kept;
    batch production stays on the one producer thread (the upstream
    iterator is rarely thread-safe).  The queue holds ``max(depth,
    workers)`` items.  Exceptions on any thread are raised at the
    consumer.  ``produce_s``, ``transfer_s`` and ``wait_s`` sum the
    producer's time in the upstream iterator, the transfers' time and the
    consumer's time blocked on the queue; ``count`` the items taken."""

    _SENTINEL = object()

    def __init__(self, iterator: Iterator, depth: int = 2,
                 transfer: Optional[Callable] = None, workers: int = 1,
                 device=None):
        self._it = iterator
        self._transfer = self._timed(transfer or (lambda b: b))
        self._q: "queue.Queue" = queue.Queue(maxsize=max(depth, workers))
        self._err: Optional[BaseException] = None
        self._done = False
        self._stop = threading.Event()
        self._enter_device = _thread_device(device)
        self._lock = threading.Lock()
        self.produce_s = self.transfer_s = self.wait_s = 0.0
        self.count = 0
        self._pool = None
        if workers > 1 and transfer is not None:
            self._pool = ThreadPoolExecutor(
                max_workers=workers, initializer=self._enter_device,
                thread_name_prefix="prefetch-transfer")
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name="prefetch-producer")
        self._thread.start()

    def _timed(self, fn):
        def timed(item):
            t0 = time.perf_counter()
            out = fn(item)
            with self._lock:
                self.transfer_s += time.perf_counter() - t0
            return out
        return timed

    def _worker(self):
        exhausted = False
        try:
            self._enter_device()
            it = iter(self._it)
            while not self._stop.is_set():
                t0 = time.perf_counter()
                try:
                    batch = next(it)
                except StopIteration:
                    exhausted = True
                    break
                self.produce_s += time.perf_counter() - t0
                if self._pool is None:
                    item = (None, self._transfer(batch))
                else:
                    # queue futures in order; the bounded queue applies
                    # backpressure to the producer
                    item = (self._pool.submit(self._transfer, batch), None)
                self._q.put(item)
        except BaseException as e:  # noqa: BLE001 - re-raised at consumer
            self._err = e
        finally:
            # stopped or failed: release the upstream's resources here (a
            # generator's pools, say) rather than whenever it is collected
            close = None if exhausted else getattr(self._it, "close", None)
            try:
                if close is not None:
                    close()
            finally:
                self._q.put(self._SENTINEL)

    def __iter__(self):
        return self

    def __next__(self):
        if self._done:
            raise StopIteration
        t0 = time.perf_counter()
        item = self._q.get()
        if item is self._SENTINEL:
            self.wait_s += time.perf_counter() - t0
            self._done = True
            if self._pool is not None:
                self._pool.shutdown(wait=False)
            if self._err is not None:
                err, self._err = self._err, None
                raise err
            raise StopIteration
        fut, value = item
        value = value if fut is None else fut.result()
        self.wait_s += time.perf_counter() - t0
        self.count += 1
        return value

    def close(self) -> None:
        """Stop the producer, drop what it staged, and join every thread;
        the upstream iterator is closed unless it ran to its end.  Safe to
        call more than once, and after the last item."""
        self._stop.set()
        while self._thread.is_alive():
            self._drain()
            self._thread.join(timeout=0.01)
        self._drain()
        if self._pool is not None:
            self._pool.shutdown(wait=True, cancel_futures=True)
        self._done = True

    def _drain(self) -> None:
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                return
            if item is not self._SENTINEL and item[0] is not None:
                item[0].cancel()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def device_put_batch(batch, device="cuda"):
    """Copy every numpy field of a dataclass, or every numpy leaf of a
    nested tuple, list or dict, to ``device``; other values are kept.  On
    CUDA the host side is pinned and the copy ``non_blocking`` on the
    current stream."""
    device = torch.device(device)
    cuda = device.type == "cuda"

    def put(x):
        if isinstance(x, np.ndarray):
            t = torch.from_numpy(np.ascontiguousarray(x))
            if cuda:
                return t.pin_memory().to(device, non_blocking=True)
            return t.to(device)
        if isinstance(x, dict):
            return {k: put(v) for k, v in x.items()}
        if isinstance(x, tuple) and hasattr(x, "_fields"):  # namedtuple
            return type(x)(*(put(v) for v in x))
        if isinstance(x, (tuple, list)):
            return type(x)(put(v) for v in x)
        return x

    if dataclasses.is_dataclass(batch) and not isinstance(batch, type):
        return dataclasses.replace(batch, **{
            f.name: put(getattr(batch, f.name))
            for f in dataclasses.fields(batch) if f.init})
    return put(batch)


@dataclasses.dataclass
class Staged:
    """A transfer's result, the event behind its copy and the consumer's
    stream (both None on the CPU); ``get()`` makes that stream wait on the
    event and returns the value."""

    value: Any
    event: Optional["torch.cuda.Event"] = None
    stream: Optional["torch.cuda.Stream"] = None

    def get(self):
        if self.event is not None:
            self.stream.wait_event(self.event)
        return self.value


def four_byte_parts(arrays: Sequence[np.ndarray]) -> List[np.ndarray]:
    """``arrays`` as contiguous arrays of 4-byte types (int32, f32), which
    one int32 buffer carries by their bits."""
    parts = [np.ascontiguousarray(a) for a in arrays]
    if any(p.dtype.itemsize != 4 for p in parts):
        raise TypeError("staging takes 4-byte arrays, got "
                        f"{[str(p.dtype) for p in parts]}")
    return parts


def split_views(flat: torch.Tensor, parts: Sequence[np.ndarray]
                ) -> List[torch.Tensor]:
    """Views of the int32 buffer ``flat`` laid out as ``parts`` side by
    side, each with its own dtype and shape."""
    views, start = [], 0
    for p in parts:
        dtype = torch.from_numpy(p[:0].reshape(-1)).dtype
        views.append(flat[start:start + p.size].view(dtype).view(p.shape))
        start += p.size
    return views


class PinnedRing:
    """Copies of 4-byte host arrays to one CUDA ``device`` through
    ``slots`` pinned buffers, on a stream of its own.

    ``copy`` may run on several threads at once: each call takes the
    least recently used slot, waits for the event behind that slot's last
    copy (the only host wait: a slot is never rewritten while a copy reads
    it), gathers the arrays into it, grows it only if they do not fit,
    and enqueues the copy.  The device tensors are allocated on the side
    stream and handed to the consumer's stream (``consumer``: the current
    stream of ``device`` on the thread that makes the ring), so the
    caching allocator does not reuse them while a step still reads them."""

    def __init__(self, device, slots: int):
        if _cuda_index(device) is None:
            raise ValueError(f"PinnedRing copies to a CUDA device, not "
                             f"{device}")
        self.device = torch.device("cuda", _cuda_index(device))
        with torch.cuda.device(self.device):
            self.stream = torch.cuda.Stream(self.device)
            self.consumer = torch.cuda.current_stream(self.device)
        self._free: "queue.Queue" = queue.Queue()
        for _ in range(slots):
            self._free.put((torch.empty(0, dtype=torch.int32,
                                        pin_memory=True), None))
        self._lock = threading.Lock()
        self.grown = 0  # slots reallocated for a larger item

    def copy(self, parts: Sequence[np.ndarray], one_buffer: bool = True
             ) -> Tuple[List[torch.Tensor], "torch.cuda.Event"]:
        """``parts`` (``four_byte_parts``) on the device: views of one
        buffer laid out as ``stage_chunk`` lays them (``one_buffer``), or
        one tensor each, as separate ``.to(device)`` calls give them; and
        the event that completes the copy."""
        n = sum(p.size for p in parts)
        buf, event = self._free.get()
        try:
            if event is not None:
                event.synchronize()
            if buf.numel() < n:
                buf = torch.empty(n, dtype=torch.int32, pin_memory=True)
                with self._lock:
                    self.grown += 1
            host = buf[:n]
            np.concatenate([p.view(np.int32).reshape(-1) for p in parts],
                           out=host.numpy())
            with torch.cuda.device(self.device), \
                    torch.cuda.stream(self.stream):
                if one_buffer:
                    flat = torch.empty(n, dtype=torch.int32,
                                       device=self.device)
                    flat.copy_(host, non_blocking=True)
                    flat.record_stream(self.consumer)
                    out = split_views(flat, parts)
                else:
                    out = []
                    for src, p in zip(split_views(host, parts), parts):
                        dst = torch.empty(p.shape, dtype=src.dtype,
                                          device=self.device)
                        dst.copy_(src, non_blocking=True)
                        dst.record_stream(self.consumer)
                        out.append(dst)
        finally:
            # recorded even when a copy failed to enqueue, so the slot
            # waits for whatever copy did
            event = torch.cuda.Event()
            event.record(self.stream)
            self._free.put((buf, event))
        return out, event
