"""``data.loader``: the producer threads and the pinned ring, with sources
whose batches are known (batch i holds the value i everywhere). On the CPU:
a fast producer and a slow consumer over many batches get every batch in
order and intact, K batches a slot with ``stack``; a producer error is
raised in the consumer (no batch skipped); ``host`` is the last batch's
slot until the next is asked for; closing stops the producer and closes the
source; a stress run with more filling threads than cores and a short
switch interval. Marked ``cuda`` (skipped without a card): the same over
the pinned ring and the side-stream copies, the consumer holding the card
busy and never synchronizing until the end, every device batch equal to the
host batch it came from. This file imports no JAX."""
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from incomplete_multimodal_fusion_tpu_torch.data.loader import DeviceLoader, host_batches


class Counting:
    """Batch i: every element i (as float32 and int32), written row by row by
    ``threads`` threads; raises on batch ``fail_at``."""

    def __init__(self, rows=4, width=1024, threads=1, fail_at=None, delay=0.0):
        self.specs = {"x": ((rows, width), np.dtype(np.float32)), "n": ((rows,), np.dtype(np.int32))}
        self.i, self.fail_at, self.delay = 0, fail_at, delay
        self.pool = ThreadPoolExecutor(threads) if threads > 1 else None
        self.closed = False

    def fill(self, out):
        if self.i == self.fail_at:
            raise OSError(f"batch {self.i} unreadable")
        i = self.i

        def row(r):
            out["x"][r] = i
            out["n"][r] = i

        rows = range(out["x"].shape[0])
        if self.pool is None:
            for r in rows:
                row(r)
        else:
            list(self.pool.map(row, rows))
        self.i += 1
        time.sleep(self.delay)

    def close(self):
        self.closed = True
        if self.pool is not None:
            self.pool.shutdown()


def _check(batch, i):
    x, n = (np.asarray(batch[k].cpu()) for k in ("x", "n"))
    assert (x == i).all() and (n == i).all(), (i, np.unique(x), np.unique(n))


@pytest.mark.parametrize("stack", [1, 3])
def test_fast_producer_slow_consumer_gets_every_batch_in_order(stack):
    source = Counting()
    with DeviceLoader(source, "cpu", depth=2, stack=stack) as loader:
        for g in range(40):
            batch = next(loader)
            if stack == 1:
                _check(batch, g)
                assert loader.host["x"][0, 0] == g  # the slot it came from, still intact
            else:
                assert batch["x"].shape == (stack, 4, 1024)
                for j in range(stack):
                    _check({k: v[j] for k, v in batch.items()}, g * stack + j)
            time.sleep(0.002)  # the producer is ahead, waiting for a slot
    assert source.closed and not loader.thread.is_alive()
    assert len(loader.wait_s) == 40 and len(loader.fill_s) >= 40 and loader.pinned_bytes == 0


def test_a_producer_error_is_raised_not_skipped():
    with DeviceLoader(Counting(fail_at=2), "cpu") as loader:
        _check(next(loader), 0)
        _check(next(loader), 1)
        with pytest.raises(OSError, match="batch 2 unreadable"):
            next(loader)
    it = host_batches(Counting(fail_at=1))
    assert next(it)["x"][0, 0] == 0
    with pytest.raises(OSError, match="batch 1 unreadable"):
        next(it)


def test_host_batches_in_order_and_closing_stops_the_producer():
    source = Counting(delay=0.001)
    before = set(threading.enumerate())
    it = host_batches(source, prefetch=2)
    for i in range(10):
        _check({k: torch.from_numpy(v) for k, v in next(it).items()}, i)
    producer, = [t for t in threading.enumerate() if t not in before and t.name == "host_batches"]
    it.close()
    assert source.closed and not producer.is_alive()


def test_host_and_arguments_are_checked():
    with DeviceLoader(Counting(), "cpu") as loader:
        with pytest.raises(RuntimeError, match="no batch"):
            loader.host
    with pytest.raises(ValueError, match="depth"):
        DeviceLoader(Counting(), "cpu", depth=1)
    with pytest.raises(RuntimeError, match="closed"):
        next(loader)


def test_stress_many_filling_threads_short_switch_interval():
    """More filling threads than cores, the interpreter switching threads
    every microsecond: every row of every batch still its batch's."""
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        source = Counting(rows=64, width=256, threads=32)
        t0 = time.time()
        with DeviceLoader(source, "cpu", depth=3) as loader:
            for i in range(150):
                _check(next(loader), i)
        assert time.time() - t0 < 60
    finally:
        sys.setswitchinterval(interval)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: pinned memory and the side-stream copies")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("stack", [1, 2])
def test_pinned_ring_never_overwrites_a_buffer_in_flight(dev, stack):
    """64 MB batches through 2 pinned slots: the producer refills a slot as
    soon as the ring allows, the consumer keeps the card busy after each
    batch and synchronizes only at the end; every device batch must be the
    host batch it was copied from."""
    source = Counting(rows=16, width=1 << 20)
    kept = []
    with DeviceLoader(source, dev, depth=2, stack=stack) as loader:
        assert loader.pinned_bytes == 2 * stack * 16 * (1 << 20) * 4 + 2 * stack * 16 * 4
        assert all(t.is_pinned() for slot in loader.slots for t in slot.values())
        for _ in range(24):
            batch = next(loader)
            assert batch["x"].device.type == "cuda"
            torch.cuda._sleep(2_000_000)  # the compute stream busy: the copies run beside it
            kept.append({k: v * 1 for k, v in batch.items()})  # used on the compute stream
    torch.cuda.synchronize()
    for g, batch in enumerate(kept):
        for j in range(stack):
            _check({k: v[j] for k, v in batch.items()} if stack > 1 else batch, g * stack + j)


@pytest.mark.cuda
def test_device_batch_is_its_pinned_host_batch_bitwise(dev):
    rng = np.random.default_rng(0)

    class Random:
        specs = {"x": ((8, 3, 64, 64), np.dtype(np.float32))}

        def fill(self, out):
            out["x"][...] = rng.standard_normal(out["x"].shape, dtype=np.float32)

        def close(self):
            pass

    with DeviceLoader(Random(), dev) as loader:
        for _ in range(5):
            batch = next(loader)
            torch.cuda.current_stream(dev).synchronize()
            assert torch.equal(batch["x"].cpu(), torch.from_numpy(loader.host["x"]))
