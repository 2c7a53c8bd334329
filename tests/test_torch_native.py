"""The port's native runtime bridge: aligned allocator and SPSC ring.

Mirrors tests/test_native.py's ``aligned_empty`` and ``SpscRing`` cases on
``nnstreamer_tpu_torch/utils/native.py`` (the same ``native/nns_runtime.cpp``,
built by the port into its own build directory), and holds the ring's
behaviour against the JAX bridge's on the same operations. Each threaded
test joins under a timeout and fails instead of hanging.
"""

import threading

import numpy as np
import pytest

pytest.importorskip("torch")

from nnstreamer_tpu.utils import native as jnative  # noqa: E402
from nnstreamer_tpu_torch.utils import native  # noqa: E402

requires_native = pytest.mark.skipif(not native.native_available(),
                                     reason="g++ toolchain unavailable")


class TestAlignedAlloc:
    @requires_native
    @pytest.mark.parametrize("alignment", [64, 128, 4096])
    def test_alignment(self, alignment):
        arr = native.aligned_empty((100, 100), np.float32, alignment)
        assert arr.ctypes.data % alignment == 0
        arr[:] = 1.0
        assert arr.sum() == 10000

    def test_fallback_shape(self):
        arr = native.aligned_empty((4, 4), np.uint8)
        assert arr.shape == (4, 4) and arr.dtype == np.uint8

    def test_zero_bytes_and_scalar_shape(self):
        assert native.aligned_empty((0, 3), np.float32).shape == (0, 3)
        assert native.aligned_empty((), np.int64).shape == ()

    @requires_native
    def test_views_outlive_nothing_and_free_once(self):
        """Many arrays allocated and collected: each frees its allocation
        once (a double free would abort the process)."""
        for i in range(200):
            arr = native.aligned_empty((i + 1, 7), np.float64)
            view = arr[1:]
            assert view._nns_ptr is None
            del arr, view


@requires_native
class TestSpscRing:
    def test_push_pop(self):
        ring = native.SpscRing(16, 256)
        assert ring.pop() is None
        assert ring.push(b"hello")
        assert ring.push(b"world")
        assert len(ring) == 2
        assert ring.pop() == b"hello"
        assert ring.pop() == b"world"
        ring.close()

    def test_full(self):
        ring = native.SpscRing(4, 64)
        for i in range(4):
            assert ring.push(bytes([i]))
        assert not ring.push(b"x")  # full
        ring.close()

    def test_oversized_record(self):
        ring = native.SpscRing(4, 8)
        with pytest.raises(ValueError):
            ring.push(b"x" * 100)
        ring.close()

    def test_capacity_not_a_power_of_two_fails(self):
        with pytest.raises(RuntimeError, match="2\\^n"):
            native.SpscRing(6, 64)

    def test_same_as_the_jax_bridge(self):
        """A seeded script of pushes and pops: every result and size equal
        to the JAX bridge's ring's."""
        rng = np.random.default_rng(3)
        rings = [native.SpscRing(8, 32), jnative.SpscRing(8, 32)]
        logs = [[], []]
        for _ in range(400):
            if rng.random() < 0.55:
                rec = rng.bytes(int(rng.integers(0, 33)))
                for r, log in zip(rings, logs):
                    log.append(("push", r.push(rec), len(r)))
            else:
                for r, log in zip(rings, logs):
                    log.append(("pop", r.pop(), len(r)))
        assert logs[0] == logs[1]
        for r in rings:
            r.close()

    def test_threaded_producer_consumer(self):
        ring = native.SpscRing(256, 64)
        n = 10000
        got = []

        def producer():
            for i in range(n):
                rec = i.to_bytes(4, "little")
                while not ring.push(rec):
                    pass

        def consumer():
            while len(got) < n:
                rec = ring.pop()
                if rec is not None:
                    got.append(int.from_bytes(rec, "little"))

        t1 = threading.Thread(target=producer, daemon=True)
        t2 = threading.Thread(target=consumer, daemon=True)
        t1.start()
        t2.start()
        t1.join(30)
        t2.join(30)
        assert not t1.is_alive() and not t2.is_alive(), "ring threads hung"
        assert got == list(range(n))
        ring.close()
