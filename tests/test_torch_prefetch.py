"""The port's DevicePrefetcher (``data/prefetch.py``): the six cases of the
JAX package's ``tests/test_prefetch.py`` (order and exhaustion, overlap
with the consumer, producer and placement errors at their position, an
abandoned iterator, next after exhaustion), and a trainer epoch with
``prefetch_depth=2`` that equals one without, loss for loss and parameter
for parameter (the same batches in the same order; only the copies move).
"""

import threading
import time

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread per xdist worker)
from test_torch_dispatch import _trainer
from multi_modal_foundation_model_tpu_torch.data.prefetch import (
    DevicePrefetcher, pinned_batch_placer)


def test_order_and_exhaustion():
    items = list(range(20))
    out = list(DevicePrefetcher(iter(items), lambda x: x * 2, depth=3))
    assert out == [x * 2 for x in items]


def test_overlaps_consumer():
    # placement sleeps; a depth-2 pipeline must run it concurrently with
    # the (slow) consumer instead of serializing
    def place(x):
        time.sleep(0.05)
        return x

    t0 = time.perf_counter()
    for _ in DevicePrefetcher(iter(range(10)), place, depth=2):
        time.sleep(0.05)  # consumer work
    elapsed = time.perf_counter() - t0
    assert elapsed < 0.85  # serialized would be ~1.0s


def test_producer_error_propagates():
    def gen():
        yield 1
        yield 2
        raise RuntimeError("boom")

    it = DevicePrefetcher(gen(), lambda x: x, depth=2)
    assert next(it) == 1
    assert next(it) == 2
    with pytest.raises(RuntimeError, match="boom"):
        next(it)


def test_placement_error_propagates():
    def place(x):
        if x == 3:
            raise ValueError("bad batch")
        return x

    it = DevicePrefetcher(iter(range(5)), place, depth=1)
    seen = []
    with pytest.raises(ValueError, match="bad batch"):
        for x in it:
            seen.append(x)
    assert seen == [0, 1, 2]


def test_abandoned_iterator_releases_producer():
    started = threading.Event()

    def gen():
        for i in range(100):
            started.set()
            yield i

    it = DevicePrefetcher(gen(), lambda x: x, depth=1)
    assert next(it) == 0
    started.wait(1.0)
    it.close()                    # consumer abandons mid-stream
    it._thread.join(2.0)
    assert not it._thread.is_alive()
    with pytest.raises(StopIteration):
        next(it)                  # post-close next raises, never blocks


def test_next_after_exhaustion_raises():
    it = DevicePrefetcher(iter([1]), lambda x: x, depth=1)
    assert next(it) == 1
    with pytest.raises(StopIteration):
        next(it)
    with pytest.raises(StopIteration):
        next(it)                  # second call must not block


def test_pinned_placer_on_the_cpu_copies_the_keys():
    batch = {"a": np.arange(6).reshape(2, 3), "b": np.ones(2), "n_real": 2}
    out = pinned_batch_placer(("a", "b"), "cpu")(batch)
    assert set(out) == {"a", "b"}
    assert torch.equal(out["a"], torch.arange(6).reshape(2, 3))


def test_trainer_epoch_with_prefetch_equals_one_without(tmp_path):
    plain = _trainer(tmp_path / "p", eval_loader=False)
    pre = _trainer(tmp_path / "f", eval_loader=False, prefetch_depth=2)
    lp = [plain.train_epoch(e)["step_losses"] for e in range(2)]
    lf = [pre.train_epoch(e)["step_losses"] for e in range(2)]
    assert lp == lf and np.isfinite(lp[0]).all()
    for (n, a), b in zip(plain.model.state_dict().items(),
                         pre.model.state_dict().values()):
        torch.testing.assert_close(a, b, atol=0, rtol=0, msg=n)
