"""Two hooks of the JAX package's API that the port now has too.

* ``TensorBatch.health_probe``: the pending buffers against the
  backpressure bound, read by the health watchdog's queue-dwell rule. A
  stalled ``tensor_batch`` must take the same verdicts and events in both
  packages (tests/test_torch_health.py's scenario form).
* ``SingleShot(accelerator=, timeout_s=)``: the JAX signature. The port
  resolves ``accelerator=`` as its filter element does, and an explicit
  ``device=`` wins over it.
"""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from nnstreamer_tpu.graph import Pipeline as JaxPipeline  # noqa: E402
from nnstreamer_tpu.obs import events as jax_events  # noqa: E402
from nnstreamer_tpu.obs import health as jax_health  # noqa: E402
from nnstreamer_tpu.single import SingleShot as JaxSingleShot  # noqa: E402
from nnstreamer_tpu_torch.core.hw import cuda_available  # noqa: E402
from nnstreamer_tpu_torch.graph import Pipeline  # noqa: E402
from nnstreamer_tpu_torch.obs import events as obs_events  # noqa: E402
from nnstreamer_tpu_torch.obs import health as obs_health  # noqa: E402
from nnstreamer_tpu_torch.single import SingleShot  # noqa: E402
from test_torch_health import _isolated  # noqa: E402


@pytest.mark.parametrize("props,bound", [({"max_batch": 3}, 12),
                                         ({"max_batch": 3, "max_pending": 5}, 5),
                                         ({}, 32)])
def test_batch_health_probe_equals_jax(props, bound):
    got = Pipeline(device="cpu").add_new("tensor_batch", **props)
    ref = JaxPipeline().add_new("tensor_batch", **props)
    assert got.health_probe() == ref.health_probe() == {"depth": 0, "bound": bound}
    for el in (got, ref):
        el._dq.extend([object()] * 2)
    assert got.health_probe() == ref.health_probe() == {"depth": 2, "bound": bound}


def _stalled_batch(pipeline):
    """A tensor_batch whose worker has stopped with its pending queue at
    the bound (max_batch 2: bound 8), then drained."""
    def scenario(h, ev):
        ev.enable()
        h.enable(stall_after_s=1000.0, queue_dwell_s=0.0, interval_s=60.0)
        el = pipeline.add_new("tensor_batch", name="b0", max_batch=2)

        def probe():
            return {"running": True, "eos": False, **el.health_probe()}

        c = h.component("element:p:b0", kind="element", probe=probe)
        c.beat()
        el._dq.extend([object()] * 8)
        h.check_now()
        yield c
        time.sleep(0.01)
        h.check_now()
        yield c
        el._dq.clear()
        h.check_now()
        yield c

    return scenario


def _verdicts(h, ev, scenario):
    steps = [h.status_string(c.status) for c in scenario(h, ev)]
    evs = [(e["type"], e["severity"], e["trace_id"],
            {k: v for k, v in e["attrs"].items() if not k.endswith("_s")})
           for e in ev.ring().snapshot()]
    return steps, evs


def test_stalled_batch_takes_the_dwell_verdicts_of_jax():
    r1 = _isolated(jax_health, jax_events)
    r2 = _isolated(obs_health, obs_events)
    try:
        ref = _verdicts(jax_health, jax_events, _stalled_batch(JaxPipeline()))
        mine = _verdicts(obs_health, obs_events,
                         _stalled_batch(Pipeline(device="cpu")))
    finally:
        r1()
        r2()
    assert mine == ref
    assert mine[0] == ["ok", "degraded", "ok"]
    assert [e[0] for e in mine[1]] == ["pipeline.queue_full", "pipeline.recover"]
    assert mine[1][0][3]["depth"] == 8 and mine[1][0][3]["bound"] == 8


def _affine(t):
    return t * 2 + 1


@pytest.mark.parametrize("accelerator", ["true:cpu", "false", "true:cpu,gpu"])
def test_singleshot_accelerator_and_timeout_equal_jax(accelerator):
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    want, = JaxSingleShot(model=_affine, accelerator=accelerator,
                          timeout_s=2.5).invoke(x)
    with SingleShot(model=_affine, accelerator=accelerator,
                    timeout_s=2.5) as single:
        assert single.device == torch.device("cpu")
        assert single.timeout_s == 2.5
        got, = single.invoke(x)
    np.testing.assert_array_equal(got.cpu().numpy(), np.asarray(want))


def test_singleshot_device_wins_over_accelerator():
    """With both given, ``device=`` decides, as in the filter element."""
    with SingleShot(model=_affine, device="cpu", accelerator="true:gpu") as s:
        assert s.device == torch.device("cpu")
        got, = s.invoke(np.ones(3, np.float32))
    np.testing.assert_array_equal(got.cpu().numpy(), np.full(3, 3, np.float32))


@pytest.mark.skipif(cuda_available(), reason="the card is present")
def test_singleshot_gpu_accelerator_without_a_card_raises():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SingleShot(model=_affine, accelerator="true:gpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SingleShot(model=_affine)
