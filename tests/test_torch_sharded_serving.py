"""Sharded serving inside a pipeline — the port's ``parallel.sharded_bundle``
with its leader/follower invoke (parallel/leader.py), the filter's
placement, pre-built and uneven-batch paths, and ``parallel/composite.py``
— against the JAX package, on gloo ranks on the CPU.

The six JAX cases of tests/test_parallel.py that wait on ``sharded_bundle``
(``:298``, ``:356``, ``:537``, ``:557``, ``:585``, ``:616``), at JAX's world
size 8 (``auto_mesh_2d(8)``: data 4 × model 2) and its tolerances: every
served result within rtol 2e-4 / atol 2e-5 of the JAX package's unsharded
bundle, whose flax variables (numpy) every rank loads
(``models.convert.load_flax``); the pre-built bundle's preprocess and bf16
cast at JAX's rtol 1e-2. Rank 0 serves (the pipeline or the filter), the
other seven follow; the query client runs in this process.

Port-only: a leader that raises or hangs fails the run with ``RankError``
within the collective timeout, a follower cannot call the bundle, a
pre-built bundle is never captured or coalesced, and the session's counts.
"""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import torch_ranks as tr  # noqa: E402
from nnstreamer_tpu.models.zoo import get_model as jget  # noqa: E402

BATCH, SIZE = 8, 16
SPEC = (f"zoo://mobilenet_v2?width=0.25&size={SIZE}&num_classes=8"
        f"&batch={BATCH}&dtype=float32")
TOL = dict(rtol=2e-4, atol=2e-5)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def groups():
    g = tr.Groups()
    yield g
    g.close()


@pytest.fixture(scope="module")
def jax_bundle():
    return jget(SPEC)


@pytest.fixture(scope="module")
def oracle(jax_bundle):
    """The port's unsharded bundle with the JAX bundle's variables."""
    from nnstreamer_tpu_torch.models.convert import load_flax
    from nnstreamer_tpu_torch.models.zoo import get_model

    return load_flax(get_model(SPEC, device="cpu", fresh=True),
                     _np(jax_bundle.params))


def test_query_offload_to_mesh_sharded_server(groups, jax_bundle):
    """The query server pipeline serves a mesh-sharded model: the client
    offloads frames, the leader's invoke fans each batch over the data
    axis of the 8 ranks; results equal the JAX unsharded model's."""
    from nnstreamer_tpu_torch.parallel.composite import (ServingSession,
                                                         client_pipeline)

    dims = f"3:{SIZE}:{SIZE}:{BATCH}"
    sess = ServingSession(groups(8), SPEC, dims,
                          variables=_np(jax_bundle.params))
    batches = [np.random.default_rng(i).integers(
        0, 255, (BATCH, SIZE, SIZE, 3)).astype(np.uint8) for i in range(3)]
    try:
        cp, sink, _, _ = client_pipeline(dims, sess.port(), batches)
        cp.run(timeout=120)
    finally:
        ranks = sess.stop()
    assert sink.num_buffers == 3
    ref_fn = jax.jit(jax_bundle.fn())
    for buf, x in zip(sink.buffers, batches):
        np.testing.assert_allclose(buf.memories[0].host(),
                                   np.asarray(ref_fn(x)), **TOL)
    assert ranks[0]["invokes"] == 3
    assert all(r == {"invokes": 3} for r in ranks[1:])


def test_sharded_bundle_honors_fused_preprocess_and_bf16():
    """A pre-built (``jit: False``) bundle still runs a fused preprocess
    stage and the precision cast (dropping a transform chain's math would
    give wrong results with no error); it is never captured, and the
    engine's coalesced dispatch refuses it."""
    from nnstreamer_tpu_torch.core.buffer import TensorMemory
    from nnstreamer_tpu_torch.core.graphs import CapturedFn
    from nnstreamer_tpu_torch.filters.base import FilterProps
    from nnstreamer_tpu_torch.filters.torch_cuda import TorchCudaFilter
    from nnstreamer_tpu_torch.models.zoo import ModelBundle

    served = ModelBundle("pre_sum", lambda x: x.sum(dim=-1),
                         metadata={"jit": False})
    f = TorchCudaFilter()
    f.open(FilterProps(model=served, custom="precision=bf16", device="cpu"))
    f.set_fused_preprocess(lambda x: x * 2.0 + 1.0)
    x = np.ones((2, 4), np.float32)
    out = f.invoke([TensorMemory(x)])[0].host()
    np.testing.assert_allclose(out.astype(np.float32), np.full((2,), 12.0),
                               rtol=1e-2)
    assert not isinstance(f._fn, CapturedFn)
    with pytest.raises(ValueError, match="pre-built"):
        f.invoke_coalesced([[TensorMemory(x)], [TensorMemory(x)]])
    f.close()


def test_composite_sharded_pipeline_with_query_offload(groups, jax_bundle,
                                                       oracle):
    """The composite topology at mesh scale: the sharded bundle served
    inside a full pipeline behind the query layer, results within JAX's
    tolerance of the port's unsharded oracle, which equals the JAX
    bundle's output (the same shared helper chip_smoke.py runs)."""
    from nnstreamer_tpu_torch.parallel.composite import (
        composite_sharded_query_check, uint8_frames)

    res = composite_sharded_query_check(groups(8), SPEC, oracle, BATCH, SIZE,
                                        variables=_np(jax_bundle.params))
    assert len(res["rtt"]) == 3 and res["max_abs_err"] <= 2e-5
    ref_fn = jax.jit(jax_bundle.fn())
    for x in uint8_frames(BATCH, SIZE, 3, 3):
        with torch.inference_mode():
            got = oracle.apply(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, np.asarray(ref_fn(x)), **TOL)


def test_sharded_uneven_final_batch(groups, jax_bundle):
    """batch % dp != 0 zero-pads to the next data-axis multiple inside the
    serving filter and trims the outputs."""
    rng = np.random.default_rng(0)
    xs = [rng.normal(size=(n, SIZE, SIZE, 3)).astype(np.float32)
          for n in (BATCH + 1, BATCH - 3, 1)]
    res = groups.run(8, tr.sharded_uneven, SPEC, _np(jax_bundle.params),
                     None, xs)
    lead = res[0]
    assert lead["batch_multiple"] == 4 and lead["name"] == "mobilenet_v2@4x2"
    assert not lead["captured"]
    oracle = jax.jit(jax_bundle.fn())
    for got, x in zip(lead["outs"], xs):
        ref = np.asarray(oracle(x))
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, **TOL)
    assert all(r == {"invokes": 3} for r in res[1:])


def test_sharded_reload_reshards(groups, jax_bundle):
    """A hot reload swaps the sharded program for one with other params;
    results follow the new oracle, and the input placement follows each
    swap (to the plain bundle and back)."""
    b2 = jget(SPEC + "&seed=7")
    rng = np.random.default_rng(1)
    x = rng.normal(size=(BATCH, SIZE, SIZE, 3)).astype(np.float32)
    res = groups.run(8, tr.sharded_reload, SPEC, SPEC + "&seed=7",
                     _np(jax_bundle.params), _np(b2.params), None, x)
    lead = res[0]
    want1 = np.asarray(jax.jit(jax_bundle.fn())(x))
    want2 = np.asarray(jax.jit(b2.fn())(x))
    np.testing.assert_allclose(lead["s1"], want1, **TOL)
    np.testing.assert_allclose(lead["s2"], want2, **TOL)
    np.testing.assert_allclose(lead["plain"], want1, **TOL)
    np.testing.assert_allclose(lead["s1_again"], want1, **TOL)
    assert not np.allclose(lead["s1"], lead["s2"])  # other params
    assert lead["placed_s2"] and lead["placed_plain"] == "cpu"


def test_composite_query_failover_retry(groups, jax_bundle, oracle):
    """The serving session dies mid-stream, a new one on the same ranks
    binds the same port, the client's retry path completes the stream with
    every frame within tolerance."""
    from nnstreamer_tpu_torch.parallel.composite import \
        composite_query_retry_check

    res = composite_query_retry_check(groups(8), SPEC, oracle, BATCH, SIZE,
                                      variables=_np(jax_bundle.params))
    # two sessions: frames 0-1 on the first, the rest on the second
    first, second = res["ranks"]
    assert first[0]["port"] == second[0]["port"] == res["port"]
    assert first[0]["invokes"] + second[0]["invokes"] >= 6


# -- port-only: failures, the protocol -------------------------------------- #

@pytest.mark.parametrize("how", ["raise", "hang"])
def test_leader_failure_fails_the_run_within_the_timeout(how):
    """A leader that raises, or hangs past the collective timeout, fails
    the run with RankError within about the timeout; no rank serves
    unsharded in its place."""
    from nnstreamer_tpu_torch.parallel import launch

    timeout = 3.0
    with launch.RankGroup(2, device="cpu", timeout=timeout, quiet=True) as g:
        t0 = time.monotonic()
        with pytest.raises(launch.RankError) as e:
            g.run(tr.leader_fails, SPEC, {"data": 2, "model": 1}, how,
                  wait=120)
        took = time.monotonic() - t0
        assert g.closed
    if how == "raise":
        assert e.value.rank == 0 and "leader failed" in str(e.value)
    else:
        # the follower's wait for a header timed out
        assert e.value.rank == 1
    assert took < timeout + 20, took


def test_follower_cannot_call_the_bundle(groups):
    got = groups.run(8, tr.follower_calls, SPEC, None)
    assert got[0] is None
    assert all("follow" in msg for msg in got[1:])
