"""Feeding host batches to the steps: the producer threads of the JAX
package's iterators (``dfc2023_iterator``, ``coco_batch_iterator``,
``ade_batch_iterator``) and, in place of JAX's implicit host-to-device put,
a ring of page-locked host buffers copied to the card on a side stream.

A batch source is an object with ``specs`` ({key: (shape, numpy dtype)}, a
batch's arrays), ``fill(out)`` (write the next batch into the arrays of
``out``, in the source's order, every random draw made there) and
``close()``. ``DFC2023Batches``, ``CocoBatches``, ``QuadrupletBatches`` and
``ADEBatches`` are the sources of this package.

``host_batches`` fills fresh numpy arrays on one producer thread, a few
batches ahead (the JAX iterators, batch for batch). ``DeviceLoader`` has
its producer thread write straight into a ring of pinned buffers
(``torch.empty(..., pin_memory=True)`` viewed as numpy); each batch is
copied to the device with ``non_blocking=True`` on a side stream, the
compute stream waits on the copy's event, and the step gets device
tensors. A slot goes back to the producer only when the consumer asks for
the next batch, after its copy's event has completed (the consumer waits on
it then: the copy, enqueued a step earlier, has long finished), so
``loader.host`` (the pinned arrays of the batch handed out last) stays valid
until then and the producer thread makes no CUDA call: a CUDA graph may be
captured while it fills. A producer error is raised in the consumer; no
batch is skipped.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch


def _put(q: "queue.Queue", item, stop: threading.Event) -> None:
    while not stop.is_set():
        try:
            q.put(item, timeout=0.1)
            return
        except queue.Full:
            pass


def host_batches(source, prefetch: int = 2) -> Iterator[Dict[str, np.ndarray]]:
    """``source.fill`` into fresh numpy arrays on a producer thread, up to
    ``prefetch`` batches ahead, yielded in order. A producer error is raised
    here; closing the generator stops the producer and closes the source."""
    q: "queue.Queue" = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def produce():
        try:
            while not stop.is_set():
                out = {k: np.empty(shape, dtype) for k, (shape, dtype) in source.specs.items()}
                source.fill(out)
                _put(q, out, stop)
        except Exception as e:  # the consumer raises it
            _put(q, e, stop)

    thread = threading.Thread(target=produce, daemon=True, name="host_batches")

    def batches():
        thread.start()
        try:
            while True:
                item = q.get()
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            thread.join()
            source.close()

    return batches()


class RowShard:
    """Share ``index`` of ``count`` of each batch a source fills (data
    parallelism): the source fills the global batch, its random draws taken
    in their order, into a buffer of this wrapper's, and ``fill`` hands on
    this share's rows. A reader whose per-sample draws come from one shared
    generator (the COCO, ADE and quadruplet readers) gives every rank the
    rows of the stream one device would read."""

    def __init__(self, source, index: int, count: int):
        self.source = source
        self.buf = {k: np.empty(shape, dtype) for k, (shape, dtype) in source.specs.items()}
        first = next(iter(source.specs.values()))[0][0]
        if first % count:
            raise ValueError(f"a batch of {first} does not divide {count} shares")
        local = first // count
        self.rows = slice(index * local, (index + 1) * local)
        self.specs = {k: ((local,) + tuple(shape[1:]), dtype) for k, (shape, dtype) in source.specs.items()}

    def fill(self, out: Dict[str, np.ndarray]) -> None:
        self.source.fill(self.buf)
        for k, v in out.items():
            v[...] = self.buf[k][self.rows]

    def close(self) -> None:
        self.source.close()


def _torch_dtype(dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype)).dtype


class DeviceLoader:
    """Batches of ``source`` as tensors on ``device``, through ``depth``
    page-locked host slots (plain host memory on the CPU, where the batch
    handed out is a copy of its slot). With ``stack`` K > 1 a slot holds K
    batches, [K, B, ...] a key: the input of ``make_multi_step``.

    ``fill_s`` holds the producer's seconds to fill each slot, ``wait_s``
    the consumer's seconds waiting for each batch; ``pinned_bytes`` is the
    ring's size. ``close()`` stops the producer and closes the source."""

    def __init__(self, source, device, depth: int = 3, stack: int = 1):
        if depth < 2 or stack < 1:
            raise ValueError(f"DeviceLoader: depth >= 2 and stack >= 1, got {depth}, {stack}")
        self.source, self.stack = source, stack
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        lead = (stack,) if stack > 1 else ()
        self.slots = [{k: torch.empty(lead + tuple(shape), dtype=_torch_dtype(dtype), pin_memory=self.cuda)
                       for k, (shape, dtype) in source.specs.items()} for _ in range(depth)]
        self.views = [{k: t.numpy() for k, t in slot.items()} for slot in self.slots]
        self.pinned_bytes = sum(t.numel() * t.element_size() for slot in self.slots for t in slot.values()) \
            if self.cuda else 0
        self.stream = torch.cuda.Stream(self.device) if self.cuda else None
        self.free: "queue.Queue" = queue.Queue()  # slots to fill; None stops
        self.ready: "queue.Queue" = queue.Queue()  # filled slots in order, or the producer's error
        for i in range(depth):
            self.free.put(i)
        self.held: Optional[tuple] = None  # (slot, event) of the batch handed out last
        self.fill_s: List[float] = []
        self.wait_s: List[float] = []
        self.closed = False
        self.thread = threading.Thread(target=self._produce, daemon=True, name="DeviceLoader")
        self.thread.start()

    def _produce(self) -> None:
        try:
            while True:
                slot = self.free.get()
                if slot is None or self.closed:
                    return
                t0 = time.perf_counter()
                views = self.views[slot]
                if self.stack > 1:
                    for j in range(self.stack):
                        self.source.fill({k: v[j] for k, v in views.items()})
                else:
                    self.source.fill(views)
                self.fill_s.append(time.perf_counter() - t0)
                self.ready.put(slot)
        except Exception as e:  # the consumer raises it
            self.ready.put(e)

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        if self.closed:
            raise RuntimeError("DeviceLoader: closed")
        if self.held is not None:
            slot, event = self.held
            if event is not None:
                event.synchronize()  # the slot's copy to the device has completed
            self.free.put(slot)
            self.held = None
        t0 = time.perf_counter()
        item = self.ready.get()
        self.wait_s.append(time.perf_counter() - t0)
        if isinstance(item, Exception):
            raise item
        host = self.slots[item]
        if self.cuda:
            compute = torch.cuda.current_stream(self.device)
            with torch.cuda.stream(self.stream):
                batch = {k: torch.empty(t.shape, dtype=t.dtype, device=self.device) for k, t in host.items()}
                for k, t in host.items():
                    batch[k].copy_(t, non_blocking=True)
                event = torch.cuda.Event(blocking=True)
                event.record(self.stream)
            compute.wait_event(event)
            for t in batch.values():  # allocated on the side stream, used on the compute stream
                t.record_stream(compute)
        else:
            batch = {k: t.clone() for k, t in host.items()}
            event = None
        self.held = (item, event)
        return batch

    @property
    def host(self) -> Dict[str, np.ndarray]:
        """The host arrays of the batch handed out last, valid until the next
        batch is asked for."""
        if self.held is None:
            raise RuntimeError("DeviceLoader: no batch handed out yet")
        return self.views[self.held[0]]

    def close(self) -> None:
        if self.closed:
            return
        self.closed = True
        self.free.put(None)
        self.thread.join()
        self.source.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
