"""Composite mesh-scale topology check: sharded serving under the real
pipeline scheduler, behind the query offload layer — port of
nnstreamer_tpu/parallel/composite.py.

Client pipeline → TCP → ``tensor_query_serversrc`` → ``tensor_filter``
(a sharded bundle) → ``tensor_query_serversink`` → TCP → client, every
result held against the port's unsharded bundle (the oracle).

The "pod" is a rank group (parallel/launch.py). A serving session is one
``group.run(serve_rank, ...)``: every rank builds the same base and served
bundle; rank 0 runs the server pipeline, publishes its bound port in the
session's control directory and serves until the caller writes ``stop``
there; the other ranks follow (parallel/leader.py) until the leader's
pipeline stops. The client pipeline runs in the calling process over
loopback TCP. Failover stops the session (the followers leave their
loop) and starts a new one on the same ranks, which binds the same port.

Shared by ``chip_smoke.py`` and the CPU tests
(tests/test_torch_sharded_serving.py), so the two stay in lockstep.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

__all__ = ["serve_rank", "ServingSession", "client_pipeline", "uint8_frames",
           "composite_sharded_query_check",
           "composite_query_retry_check"]


#: seconds a serving session's leader waits for its caller's ``stop``
SESSION_TIMEOUT = 600.0


def serve_rank(spec: str, dims: str, port: int, ctl: str,
               variables: Any = None) -> Dict[str, Any]:
    """A rank of a serving session. Every rank builds ``spec``'s bundle on
    its device (loading the flax ``variables`` when given) and its
    ``parallel.sharded_bundle`` over ``auto_mesh_2d``. Rank 0 serves
    ``serversrc port=port dims=dims ! tensor_filter ! serversink``, writes
    the bound port to ``ctl/port`` and stops when ``ctl/stop`` appears
    (raising the pipeline's error if it has one); the others follow.
    Returns the rank's invokes (and rank 0's port)."""
    import torch.distributed as dist

    from ..models.zoo import get_model
    from .launch import rank_device
    from .leader import follow
    from .mesh import auto_mesh_2d
    from .train import sharded_bundle

    dev = rank_device()
    base = get_model(spec, device=dev, fresh=variables is not None)
    if variables is not None:
        from ..models.convert import load_flax

        load_flax(base, variables)
    served = sharded_bundle(base, auto_mesh_2d())
    if dist.get_rank() != 0:
        return follow(served)
    return _lead(served, dims, port, ctl, dev)


def _lead(served: Any, dims: str, port: int, ctl: str, dev: Any) -> Dict[str, Any]:
    """Rank 0's part: the server pipeline, until ``ctl/stop``."""
    from ..graph import Pipeline
    from ..query.server import wait_bound_port

    types = "float32" if served.in_info is None \
        else str(served.in_info[0].dtype)
    sp = Pipeline(f"mesh-server-{port}", device=dev)
    ssrc = sp.add_new("tensor_query_serversrc", host="127.0.0.1", port=port,
                      id=0, dims=dims, types=types)
    sfilt = sp.add_new("tensor_filter", framework="xla-tpu", model=served)
    ssink = sp.add_new("tensor_query_serversink", id=0)
    Pipeline.link(ssrc, sfilt, ssink)
    sp.start()  # the filter opens here; stopping closes it: OP_STOP
    try:
        bound = wait_bound_port(ssrc, timeout_s=60)
        tmp = os.path.join(ctl, "port.tmp")
        with open(tmp, "w") as f:
            f.write(str(bound))
        os.replace(tmp, os.path.join(ctl, "port"))
        deadline = time.monotonic() + SESSION_TIMEOUT
        stop = os.path.join(ctl, "stop")
        while not os.path.exists(stop):
            err = sp.bus.error
            if err is not None:
                raise RuntimeError(f"server pipeline: {err.source}: "
                                   f"{err.data.get('text')}")
            if time.monotonic() > deadline:
                raise TimeoutError(f"serving session not stopped within "
                                   f"{SESSION_TIMEOUT:g} s")
            time.sleep(0.005)
    finally:
        sp.stop()
    return {"invokes": served.metadata["session"].invokes, "port": bound}


class ServingSession:
    """A serving session on ``group``, run in a thread of the caller:
    ``port()`` waits for rank 0's bound port, ``stop()`` ends the session
    and returns the ranks' results (raising a rank's ``RankError``)."""

    def __init__(self, group: Any, spec: str, dims: str, port: int = 0,
                 variables: Any = None) -> None:
        self.ctl = tempfile.mkdtemp(prefix="nns_serve_")
        self.result: Optional[List[Any]] = None
        self.error: Optional[BaseException] = None
        self._stopped = False

        def run() -> None:
            try:
                self.result = group.run(serve_rank, spec, dims, port, self.ctl,
                                        variables)
            except BaseException as e:  # noqa: BLE001 — raised by port()/stop()
                self.error = e

        self._thread = threading.Thread(target=run, name="serving-session",
                                        daemon=True)
        self._thread.start()

    def port(self, timeout: float = 300.0) -> int:
        path = os.path.join(self.ctl, "port")
        deadline = time.monotonic() + timeout
        while not os.path.exists(path):
            if not self._thread.is_alive():
                self._thread.join()
                raise self.error or RuntimeError(
                    "serving session ended before it bound a port")
            if time.monotonic() > deadline:
                raise TimeoutError(f"no bound port within {timeout:g} s")
            time.sleep(0.005)
        with open(path) as f:
            return int(f.read())

    def stop(self, timeout: float = 300.0) -> List[Any]:
        if not self._stopped:
            self._stopped = True
            with open(os.path.join(self.ctl, "stop"), "w"):
                pass
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise TimeoutError(f"serving session did not end within {timeout:g} s")
        shutil.rmtree(self.ctl, ignore_errors=True)
        if self.error is not None:
            raise self.error
        return self.result


def uint8_frames(batch: int, size: int, n: int, seed: int) -> List[np.ndarray]:
    """uint8 frames: the zoo serving contract (in_info uint8; the [-1, 1]
    preprocess runs inside the model)."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 255, (batch, size, size, 3)).astype(np.uint8)
            for _ in range(n)]


def client_pipeline(dims: str, port: int, frames: Any, **props: Any):
    """(pipeline, sink, send times, arrival times) of ``appsrc !
    tensor_query_client ! tensor_sink`` over ``frames``."""
    from ..core.types import Caps, TensorsConfig, TensorsInfo
    from ..graph import Pipeline

    sent: List[float] = []
    arrived: List[float] = []

    def gen():
        for f in frames:
            sent.append(time.perf_counter())
            yield f

    cp = Pipeline("mesh-client")
    caps = Caps.tensors(TensorsConfig(TensorsInfo.from_strings(dims, "uint8")))
    csrc = cp.add_new("appsrc", caps=caps, data=gen())
    qc = cp.add_new("tensor_query_client", host="127.0.0.1", port=port, **props)
    csink = cp.add_new("tensor_sink", store=True,
                       new_data=lambda b: arrived.append(time.perf_counter()))
    Pipeline.link(csrc, qc, csink)
    return cp, csink, sent, arrived


def _check_oracle(oracle: Any, frames: Sequence[np.ndarray], sink: Any,
                  rtol: float, atol: float, what: str) -> Dict[str, Any]:
    """Every returned frame within rtol/atol of ``oracle`` (the port's
    unsharded bundle) on the same frame; the largest difference, the
    returned outputs and the oracle's."""
    import torch

    worst = 0.0
    got_all, want_all = [], []
    dev = oracle.device if oracle.device is not None else "cpu"
    for i, fx in enumerate(frames):
        got = sink.buffers[i].memories[0].host()
        with torch.inference_mode():
            ref = oracle.apply(torch.from_numpy(fx).to(dev))
        ref = ref.float().cpu().numpy()
        if got.shape != ref.shape or not np.allclose(got, ref, rtol=rtol,
                                                     atol=atol):
            raise AssertionError(f"{what} frame {i} diverged (max abs "
                                 f"{np.abs(got - ref).max():.3e})")
        worst = max(worst, float(np.abs(got - ref).max()))
        got_all.append(got)
        want_all.append(ref)
    return {"max_abs_err": worst, "outputs": got_all, "oracle": want_all}


def composite_sharded_query_check(group: Any, spec: str, oracle: Any,
                                  batch: int, size: int, n_frames: int = 3,
                                  seed: int = 3, rtol: float = 2e-4,
                                  atol: float = 2e-5, *,
                                  variables: Any = None) -> Dict[str, Any]:
    """Serve ``spec``'s sharded bundle on ``group`` inside a full server
    pipeline and stream ``n_frames`` uint8 frames through a query client;
    every result must match ``oracle``, the unsharded bundle (built from the
    same spec, or loaded with the same ``variables``). Raises
    AssertionError on any divergence; returns the client's wall and round
    trips, the largest difference, the outputs and the oracle's, and the
    ranks' results."""
    dims = f"3:{size}:{size}:{batch}"
    frames = uint8_frames(batch, size, n_frames, seed)
    sess = ServingSession(group, spec, dims, 0, variables)
    try:
        port = sess.port()
        cp, csink, sent, arrived = client_pipeline(dims, port, frames, timeout_s=120.0)
        t0 = time.perf_counter()
        cp.run(timeout=300)
        wall = time.perf_counter() - t0
    finally:
        ranks = sess.stop()
    assert csink.num_buffers == n_frames, \
        f"composite: {csink.num_buffers}/{n_frames} frames returned"
    checked = _check_oracle(oracle, frames, csink, rtol, atol,
                            "composite sharded pipeline")
    return {"wall": wall, "rtt": [a - s for a, s in zip(arrived, sent)],
            "ranks": ranks, "port": port, **checked}


def composite_query_retry_check(group: Any, spec: str, oracle: Any,
                                batch: int, size: int, n_frames: int = 6,
                                seed: int = 11, rtol: float = 2e-4,
                                atol: float = 2e-5, *,
                                variables: Any = None) -> Dict[str, Any]:
    """Failover on the query edge at mesh scale: the serving session dies
    mid-stream and a new one on the same ranks binds the same port; the
    client's synchronous retry path (``max_request_retry``) must resend and
    complete the stream with every result matching ``oracle``."""
    dims = f"3:{size}:{size}:{batch}"
    frames = uint8_frames(batch, size, n_frames, seed)
    sess1 = ServingSession(group, spec, dims, 0, variables)
    sess2: Optional[ServingSession] = None
    ranks: List[Any] = []
    try:
        port = sess1.port()
        # the failover must be mid-stream whatever the speed: the source
        # parks before frame 2 until the session has been stopped, so
        # frame 2 always meets a dead port and must ride the retry loop
        reached_gate = threading.Event()
        gate_release = threading.Event()

        def paced():
            for i, f in enumerate(frames):
                if i == 2:
                    reached_gate.set()
                    if not gate_release.wait(120):
                        raise RuntimeError("failover gate never released")
                yield f

        cp, csink, _, _ = client_pipeline(dims, port, paced(), timeout_s=60.0,
                                  max_request_retry=20)
        client_err: List[BaseException] = []

        def run_client() -> None:
            try:
                cp.run(timeout=300)
            except Exception as e:  # noqa: BLE001 — surfaced after join
                client_err.append(e)

        th = threading.Thread(target=run_client, daemon=True)
        th.start()
        assert reached_gate.wait(120), "stream never reached the gate"
        deadline = time.monotonic() + 60
        while csink.num_buffers < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert csink.num_buffers >= 2, "first frames never returned"
        ranks.append(sess1.stop())  # the followers leave their loop
        sess1 = None
        gate_release.set()          # frame 2 now fires at the dead port
        time.sleep(0.4)             # let at least one connect attempt fail
        sess2 = ServingSession(group, spec, dims, port, variables)
        sess2.port()
        th.join(timeout=300)
        assert not th.is_alive(), "client did not finish after failover"
        if client_err:
            raise AssertionError(
                f"client failed across failover: {client_err[0]}")
    finally:
        for s in (sess1, sess2):
            if s is not None:
                ranks.append(s.stop())
    assert csink.num_buffers == n_frames, \
        f"failover: {csink.num_buffers}/{n_frames} frames returned"
    checked = _check_oracle(oracle, frames, csink, rtol, atol, "failover")
    return {"ranks": ranks, "port": port, **checked}
