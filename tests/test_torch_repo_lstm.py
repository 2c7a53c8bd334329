"""The port's LSTM cell and the repo-LSTM loop against the JAX package.

``models/lstm.py`` is flax's ``nn.LSTMCell`` in torch; ``models/convert.py``
carries a flax cell's params across (input kernels without bias, recurrent
kernels with bias). On the same seeded float32 inputs the port's cell gives
the JAX bundle's ``(y, h', c')`` within rtol 1e-5 and atol 1e-6: XLA's dot
and the CPU BLAS sum the products in different orders (about 3e-7 apart
here), and neither path contracts or reorders the gate arithmetic.

The loop is bench.py's composite path without its query hop (BASELINE
config 5): ``appsrc → tensor_mux sync_mode=nosync ← tensor_reposrc →
tensor_filter model=<lstm cell> → tensor_demux tensorpick=0,1:2 → [queue
→ tensor_sink], [queue → tensor_reposink]``. At features 8 over 16 steps the
port's outputs follow the JAX loop's within the same tolerance: the error
does not compound, since the cell's gates contract it. The same loop
with CUDA graphs equals ``graphs.disabled()`` byte for byte (on the CPU
both run eagerly; the ``cuda`` case holds the replays on the card, where a
graph's outputs are fed back into its next call through the repo slot).
"""

import contextlib
import time
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import nnstreamer_tpu.core as jcore  # noqa: E402
import nnstreamer_tpu.graph as jgraph  # noqa: E402
from nnstreamer_tpu.elements.repo import reset_repo as jax_reset_repo  # noqa: E402
import nnstreamer_tpu_torch.core as tcore  # noqa: E402
import nnstreamer_tpu_torch.graph as tgraph  # noqa: E402
from nnstreamer_tpu_torch.core import graphs  # noqa: E402
from nnstreamer_tpu_torch.elements.repo import reset_repo  # noqa: E402
from nnstreamer_tpu_torch.models.convert import (flax_shapes,  # noqa: E402
                                                 from_flax_variables)
from nnstreamer_tpu_torch.models.lstm import (LSTMCell, cell_bundle,  # noqa: E402
                                              make_lstm_cell)
from nnstreamer_tpu_torch.models.zoo import get_model  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
TIMEOUT = 60
SLOT = 77


def jax_bundle(features, d_in, seed):
    # flax is imported here, not with the module: the card's machine has
    # no flax, and the ``cuda`` case below needs none
    from nnstreamer_tpu.models.lstm import make_lstm_cell

    return make_lstm_cell(features=str(features), input_size=str(d_in), seed=str(seed))


def port_cell(jb):
    """The port's cell carrying the JAX bundle's params."""
    params = jax.tree_util.tree_map(np.array, jb.params)
    d_in, f = params["params"]["ii"]["kernel"].shape
    cell = LSTMCell(d_in, f)
    from_flax_variables(params, cell)
    return cell.eval()


@pytest.mark.parametrize("features,d_in,seed", [(8, 4, 0), (64, 32, 3), (5, 7, 11)])
def test_cell_carries_flax_params(features, d_in, seed):
    jb = jax_bundle(features, d_in, seed)
    cell = port_cell(jb)
    assert jax.tree_util.tree_map(np.shape, jb.params) == {
        "params": {k: dict(v) for k, v in flax_shapes(cell)["params"].items()}}
    rng = np.random.default_rng(seed)
    x, h, c = (rng.standard_normal((2, n)).astype(np.float32)
               for n in (d_in, features, features))
    want = [np.asarray(a) for a in jax.jit(jb.apply)(jb.params, x, h, c)]
    with torch.inference_mode():
        got = [t.numpy() for t in cell_bundle(cell, 2).fn()(
            torch.from_numpy(x), torch.from_numpy(h), torch.from_numpy(c))]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
    assert np.array_equal(got[0], got[1])  # y is h'


def test_zoo_lstm_cell():
    b = get_model("zoo://lstm_cell?features=8&input_size=4", device="cpu")
    assert [t.shape for t in b.in_info] == [(1, 4), (1, 8), (1, 8)]
    assert [t.shape for t in b.out_info] == [(1, 8)] * 3
    w0 = b.module.ii.weight.detach().clone()
    other = get_model("zoo://lstm_cell?features=8&input_size=4&seed=1", device="cpu")
    assert not torch.equal(w0, other.module.ii.weight)
    assert torch.count_nonzero(b.module.hi.bias) == 0  # zeros, as flax inits


def loop(ns, steps, model, features, d_in):
    """The repo loop; returns the sink's frames once ``steps`` arrived."""
    ns.reset_repo()
    rng = np.random.default_rng(0)
    frames = [rng.standard_normal((1, d_in)).astype(np.float32) for _ in range(steps)]
    p = ns.graph.Pipeline(**ns.kw)
    caps = ns.core.Caps.tensors(ns.core.TensorsConfig(
        ns.core.TensorsInfo.from_strings(f"{d_in}:1", "float32"), 30))
    src = p.add_new("appsrc", caps=caps, data=frames, framerate=30)
    state = p.add_new("tensor_reposrc", slot_index=SLOT,
                      dims=f"{features}:1,{features}:1", types="float32,float32")
    mux = p.add_new("tensor_mux", sync_mode="nosync")
    filt = p.add_new("tensor_filter", framework="xla-tpu", model=model)
    demux = p.add_new("tensor_demux", tensorpick="0,1:2")
    sink = p.add_new("tensor_sink", store=True)
    rsink = p.add_new("tensor_reposink", slot_index=SLOT)
    ns.graph.Pipeline.link(src, mux)
    ns.graph.Pipeline.link(state, mux)
    ns.graph.Pipeline.link(mux, filt, demux)
    ns.graph.Pipeline.link(demux, p.add_new("queue"), sink)
    ns.graph.Pipeline.link(demux, p.add_new("queue"), rsink)
    p.start()
    try:
        deadline = time.monotonic() + TIMEOUT
        while sink.num_buffers < steps and time.monotonic() < deadline:
            time.sleep(0.01)
    finally:
        p.stop()
    assert sink.num_buffers == steps, "the loop stalled"
    return sink.buffers


JNS = SimpleNamespace(graph=jgraph, core=jcore, reset_repo=jax_reset_repo, kw={})
TNS = SimpleNamespace(graph=tgraph, core=tcore, reset_repo=reset_repo,
                      kw={"device": "cpu"})


def numpy_loop(cell, steps, d_in, features):
    """The recurrence run directly on the cell, the loop's reference."""
    rng = np.random.default_rng(0)
    h = c = torch.zeros(1, features)
    ys = []
    with torch.inference_mode():
        for _ in range(steps):
            x = torch.from_numpy(rng.standard_normal((1, d_in)).astype(np.float32))
            y, h, c = cell(x, h, c)
            ys.append(y.numpy().copy())
    return ys


def test_repo_loop_matches_jax():
    features, d_in, steps = 8, 4, 16
    jb = jax_bundle(features, d_in, 5)
    cell = port_cell(jb)
    want = loop(JNS, steps, jb, features, d_in)
    got = loop(TNS, steps, cell_bundle(cell, 1, torch.device("cpu")), features, d_in)
    assert [b.pts for b in got] == [b.pts for b in want]
    for g, w in zip(got, want):
        assert g.num_tensors == w.num_tensors == 1
        np.testing.assert_allclose(g.memories[0].host(),
                                   np.asarray(w.memories[0].host()),
                                   rtol=RTOL, atol=ATOL)
    # the state really went round: the outputs are the recurrence's
    ref = numpy_loop(cell, steps, d_in, features)
    assert all(np.array_equal(g.memories[0].host(), r) for g, r in zip(got, ref))


def test_repo_loop_with_graphs_equals_eager():
    features, d_in, steps = 8, 4, 16
    model = cell_bundle(port_cell(jax_bundle(features, d_in, 5)), 1,
                        torch.device("cpu"))
    runs = []
    for eager in (False, True):
        with graphs.disabled() if eager else contextlib.nullcontext():
            out = loop(TNS, steps, model, features, d_in)
        runs.append([b.memories[0].host().tobytes() for b in out])
    assert runs[0] == runs[1]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the filter's CUDA graphs)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_repo_loop_replays_equal_eager_on_the_card(cuda_device):
    """On the card the filter's invoke replays a CUDA graph whose outputs
    go round the loop through the repo slot: 64 steps replayed must give
    the eager loop's bytes, and the CPU loop's values within the stated
    tolerance (1e-5 relative, 1e-6 absolute)."""
    features, d_in, steps = 64, 32, 64
    cell = make_lstm_cell(device=torch.device("cpu"), features=str(features),
                          input_size=str(d_in), seed="5").module
    ref = numpy_loop(cell, steps, d_in, features)
    model = cell_bundle(cell.to(cuda_device), 1, cuda_device)
    card = SimpleNamespace(**{**vars(TNS), "kw": {"device": cuda_device}})
    runs = []
    for eager in (False, True):
        graphs.reset_stats()
        with graphs.disabled() if eager else contextlib.nullcontext():
            out = loop(card, steps, model, features, d_in)
        if not eager:
            st = graphs.stats()
            assert st["captures"] == 1 and st["replays"] == steps - 1
        assert all(b.memories[0].device().device.type == "cuda" for b in out)
        runs.append([b.memories[0].host() for b in out])
    assert all(np.array_equal(a, b) and a.tobytes() == b.tobytes()
               for a, b in zip(*runs))
    for g, r in zip(runs[0], ref):
        np.testing.assert_allclose(g, r, rtol=RTOL, atol=ATOL)
