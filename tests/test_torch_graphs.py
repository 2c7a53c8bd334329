"""The port's CUDA graphs (nnstreamer_tpu_torch/core/graphs.py): one captured
program per static signature, the counterpart of ``jax.jit``'s cache.

Here, on the CPU: ``CapturedFn`` on CPU tensors is the plain call (a CPU has
no graphs), the graph key splits on shape, dtype, stride, device and the
static values, launch counts recorded during a capture are added on each
replay and not for the capture, no garbage collection runs inside a capture
(dead cycles are collected before it), ``disabled()`` nests, and the filter
recomposes (and so drops its graphs) on ``_build()`` and drops them on
``close()``.

Marked ``cuda`` (they skip here; on the card they run with ``-m cuda``):
for each filter path (the SSD reduce and DeepLab colorize fused into the
invoke, classification with the prologue fused, PoseNet, a flash prefill
bundle, ``bucket=``) every replayed output is bit-equal to the eager run of
the same inputs (``graphs.disabled()``), with one capture per signature and
the kernels' launch counts those of the eager run; the LM engine's three
programs (greedy, sampled, speculative, w8a8) give the eager tokens; a
captured kernel counts one launch per replay; a model that reads a value
back to the host (``.item()``) raises at capture, naming the callable.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from nnstreamer_tpu_torch.core import graphs  # noqa: E402
from nnstreamer_tpu_torch.core.buffer import TensorMemory  # noqa: E402
from nnstreamer_tpu_torch.filters.base import FilterProps  # noqa: E402
from nnstreamer_tpu_torch.filters.torch_cuda import TorchCudaFilter  # noqa: E402
from nnstreamer_tpu_torch.ops.kernels import epilogue as ep  # noqa: E402

CPU = torch.device("cpu")


# --------------------------------------------------------------------------- #
# on the CPU
# --------------------------------------------------------------------------- #

def test_captured_fn_on_cpu_is_the_plain_call():
    calls = []

    def fn(x, y, *, scale):
        calls.append((x, y, scale))
        return x * scale + y, {"y": y}

    cf = graphs.CapturedFn(fn, "probe")
    before = graphs.stats()
    x, y = torch.arange(6.0).reshape(2, 3), torch.ones(2, 3)
    for _ in range(3):
        out, aux = cf(x, y, scale=2.0)
        assert torch.equal(out, x * 2.0 + y) and aux["y"] is y
    assert len(calls) == 3 and all(c[0] is x for c in calls)
    assert len(cf) == 0
    assert graphs.stats() == before  # no capture, replay or warm-up


def test_captured_fn_without_tensors_runs_where_it_was_told():
    cf = graphs.CapturedFn(lambda *, n: torch.full((n,), 7), device=CPU)
    assert torch.equal(cf(n=3), torch.full((3,), 7))
    assert len(cf) == 0


def test_signature_splits_on_shape_dtype_stride_device_and_static():
    x = torch.zeros(4, 6)
    key = graphs.signature((x,), {"n": 2})
    assert key == graphs.signature((torch.ones(4, 6),), {"n": 2})
    others = [
        graphs.signature((torch.zeros(4, 7),), {"n": 2}),            # shape
        graphs.signature((torch.zeros(4, 6, dtype=torch.int32),), {"n": 2}),
        graphs.signature((torch.zeros(6, 4).t(),), {"n": 2}),        # stride
        graphs.signature((torch.zeros(4, 6, device="meta"),), {"n": 2}),
        graphs.signature((x,), {"n": 3}),                            # static
        graphs.signature((x,), {"n": 2, "greedy": True}),
        graphs.signature((x, x), {"n": 2}),
    ]
    assert all(k != key for k in others)
    assert len(set(others)) == len(others)
    # static values are keyed by name, in any order
    assert graphs.signature((x,), {"a": 1, "b": 2}) \
        == graphs.signature((x,), {"b": 2, "a": 1})


class _Counts:
    launches = 0
    launches_by_route = {"a": 0, "b": 0}


def test_launches_counted_in_a_capture_are_added_on_each_replay():
    c = _Counts()
    c.launches_by_route = {"a": 0, "b": 0}
    graphs.count(c)
    assert c.launches == 1
    recorded = []
    with graphs.recording(recorded):  # what a capture sees
        graphs.count(c)
        graphs.count(c, "launches_by_route", "b")
    assert c.launches == 1 and c.launches_by_route == {"a": 0, "b": 0}
    assert recorded == [(c, "launches", None), (c, "launches_by_route", "b")]
    for n in range(1, 4):  # three replays
        graphs.add_launches(recorded)
        assert c.launches == 1 + n and c.launches_by_route == {"a": 0, "b": n}
    graphs.count(c)  # recording ended with the block
    assert c.launches == 5


def test_disabled_nests():
    assert graphs.enabled()
    with graphs.disabled():
        assert not graphs.enabled()
        with graphs.disabled():
            assert not graphs.enabled()
        assert not graphs.enabled()
    assert graphs.enabled()
    with pytest.raises(KeyError):
        with graphs.disabled():
            raise KeyError("leaves the block")
    assert graphs.enabled()


def test_no_collection_while_capturing():
    # graphs that died in a reference cycle are destroyed before a capture,
    # and never by the collector inside one
    import gc
    import weakref

    class Node:
        pass

    a, b = Node(), Node()
    a.other, b.other = b, a
    dead = weakref.ref(a)
    del a, b
    assert gc.isenabled()
    with graphs._no_collection():
        assert dead() is None
        assert not gc.isenabled()
    assert gc.isenabled()
    # overlapping captures (two threads) share the hold: the collector
    # stays off until the last one ends
    outer, inner = graphs._no_collection(), graphs._no_collection()
    outer.__enter__()
    inner.__enter__()
    outer.__exit__(None, None, None)
    assert not gc.isenabled()
    inner.__exit__(None, None, None)
    assert gc.isenabled()


def test_filter_recomposes_and_drops_its_graphs():
    fw = TorchCudaFilter()
    fw.open(FilterProps(model=lambda x: x * 2, device=CPU))
    first = fw._fn
    assert isinstance(first, graphs.CapturedFn)
    out = fw.invoke([TensorMemory(torch.ones(2, 2))])
    assert torch.equal(out[0].device(), torch.full((2, 2), 2.0))
    fw.set_fused_epilogue(lambda outs: tuple(o + 1 for o in outs))
    second = fw._fn
    assert second is not first
    out = fw.invoke([TensorMemory(torch.ones(2, 2))])
    assert torch.equal(out[0].device(), torch.full((2, 2), 3.0))
    fw.set_fused_preprocess(lambda x: x * 10)
    assert fw._fn is not second
    out = fw.invoke([TensorMemory(torch.ones(2, 2))])
    assert torch.equal(out[0].device(), torch.full((2, 2), 21.0))
    third = fw._fn
    fw.reload_model(lambda x: x * 3)
    assert fw._fn is not third
    fw.close()
    assert fw._fn is None


# --------------------------------------------------------------------------- #
# on the card
# --------------------------------------------------------------------------- #

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs)")
    return torch.device("cuda", 0)


def _graph_and_eager(run):
    """``run()`` with graphs, then inside ``graphs.disabled()``: (graph
    outputs, eager outputs, the graphs run's stats)."""
    graphs.reset_stats()
    got = run()
    st = graphs.stats()
    with graphs.disabled():
        want = run()
    return got, want, st


def _bits_equal(a, b):
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_bits_equal(x, y) for x, y in zip(a, b))
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.reshape(-1).contiguous().view(torch.uint8),
        b.reshape(-1).contiguous().view(torch.uint8))


def _filter_run(cuda_device, model, frames, custom="", pre=None, post=None):
    def run():
        fw = TorchCudaFilter()
        fw.open(FilterProps(model=model, custom=custom, device=cuda_device))
        if pre is not None:
            fw.set_fused_preprocess(pre)
        if post is not None:
            fw.set_fused_epilogue(post)
        outs = [[m.device() for m in fw.invoke([TensorMemory(f)
                                                for f in frame])]
                for frame in frames]
        torch.cuda.synchronize()
        fw.close()
        return outs

    return run


def _frames(shape, n, dtype=np.uint8, seed=0):
    rng = np.random.default_rng(seed)
    if dtype == np.uint8:
        return [(rng.integers(0, 256, shape, dtype=np.uint8),) for _ in range(n)]
    return [(rng.standard_normal(shape).astype(dtype),) for _ in range(n)]


@pytest.mark.cuda
def test_ssd_fused_reduce_replays_the_eager_rows(cuda_device, tmp_path):
    from nnstreamer_tpu_torch.decoders.bounding_box import BoundingBox
    from nnstreamer_tpu_torch.models.ssd_mobilenet import write_box_priors

    priors = str(tmp_path / "priors.txt")
    write_box_priors(priors, size=300)
    dec = BoundingBox()
    dec.init({1: "mobilenet-ssd", 3: priors, 4: "300:300", 5: "300:300"})
    red = dec.epilogue_reduce()
    frames = _frames((1, 300, 300, 3), 5)
    launches = {}

    def run():
        before = (ep.class_reduce.launches, ep.nms_sweep.launches)
        outs = _filter_run(cuda_device, "zoo://ssd_mobilenet_v2?size=300&width=0.5",
                           frames, post=lambda outs: (red(outs),))()
        launches[graphs.enabled()] = (ep.class_reduce.launches - before[0],
                                      ep.nms_sweep.launches - before[1])
        return outs

    got, want, st = _graph_and_eager(run)
    assert _bits_equal(got, want)
    assert st == {"captures": 1, "replays": 4, "warmups": 1}
    assert launches == {True: (5, 5), False: (5, 5)}


@pytest.mark.cuda
def test_deeplab_fused_colorize_replays_the_eager_canvases(cuda_device):
    from nnstreamer_tpu_torch.decoders.image_segment import ImageSegment

    dec = ImageSegment()
    dec.init({1: "tflite-deeplab"})
    red = dec.epilogue_reduce()
    frames = _frames((1, 257, 257, 3), 4)
    before = dict(ep.segment_colorize.launches_by_route)
    got, want, st = _graph_and_eager(_filter_run(
        cuda_device, "zoo://deeplab_v3?size=257&num_classes=21&width=0.5",
        frames, post=lambda outs: (red(outs),)))
    assert _bits_equal(got, want)
    assert st["captures"] == 1 and st["replays"] == 3
    routes = {k: v - before[k] for k, v in ep.segment_colorize.launches_by_route.items()}
    assert routes == {"bulk": 8, "row": 0, "ids": 0}


@pytest.mark.cuda
def test_classification_with_a_fused_prologue_replays_the_eager_logits(cuda_device):
    from nnstreamer_tpu_torch.ops import transform_ops

    t = transform_ops.build("arithmetic", "typecast:float32,add:-127.5,div:127.5")
    per_channel = transform_ops.build("arithmetic", "mul:0.5;1.0;2.0")
    frames = _frames((1, 224, 224, 3), 4)
    for pre in (t.fn, lambda x: per_channel.fn(t.fn(x))):
        got, want, st = _graph_and_eager(_filter_run(
            cuda_device, "zoo://mobilenet_v2?width=0.5",
            frames, pre=pre))
        assert _bits_equal(got, want)
        assert st["captures"] == 1 and st["replays"] == 3


@pytest.mark.cuda
def test_posenet_and_bucketed_replay_the_eager_outputs(cuda_device):
    frames = _frames((1, 257, 257, 3), 3)
    got, want, st = _graph_and_eager(_filter_run(
        cuda_device, "zoo://posenet?size=257&width=0.5", frames))
    assert _bits_equal(got, want) and st["replays"] == 2
    rng = np.random.default_rng(2)
    regions = [tuple(rng.standard_normal((5, 4, 3)).astype(np.float32)
                     for _ in range(n)) for n in (3, 1, 6, 2, 9)]
    got, want, st = _graph_and_eager(_filter_run(
        cuda_device, lambda x: x.amax(dim=(1, 2)) * 2, regions,
        custom="bucket=4"))
    assert _bits_equal(got, want)
    # padded sizes 4, 4, 8, 4, 12: three signatures
    assert st == {"captures": 3, "replays": 2, "warmups": 3}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_prefill_bundle_replays_the_eager_logits(cuda_device, dtype):
    from nnstreamer_tpu_torch.models import causal_lm
    from nnstreamer_tpu_torch.models.convert import causal_lm_params
    from nnstreamer_tpu_torch.ops.kernels import flash_attention as fa

    params = causal_lm_params(causal_lm.init_causal_lm(0, 256, 128, 2, 2, 256),
                              cuda_device, dtype=None if dtype == torch.float32
                              else dtype)
    bundle = causal_lm.prefill_bundle(params, 2, 256, 2, flash=True)
    rng = np.random.default_rng(3)
    frames = [(rng.integers(0, 256, (2, 256)).astype(np.int32),) for _ in range(3)]
    before = fa.flash_attention.launches
    got, want, st = _graph_and_eager(_filter_run(cuda_device, bundle, frames))
    assert _bits_equal(got, want)
    assert st["captures"] == 1 and st["replays"] == 2
    assert fa.flash_attention.launches - before == 2 * 2 * 3  # layers x frames x runs


@pytest.mark.cuda
@pytest.mark.parametrize("quant,sample,spec", [
    ("float32", False, 0), ("float32", True, 0), ("float32", False, 4),
    ("w8a8", False, 0)], ids=["greedy", "sampled", "speculative", "w8a8"])
def test_engine_programs_replay_the_eager_tokens(cuda_device, quant, sample, spec):
    from nnstreamer_tpu_torch.models import causal_lm
    from nnstreamer_tpu_torch.models.convert import causal_lm_params
    from nnstreamer_tpu_torch.serving import LMEngine

    params = causal_lm_params(causal_lm.init_causal_lm(0, 128, 64, 4, 2, 128),
                              cuda_device)
    if quant == "w8a8":
        params = causal_lm.quantize_lm_params(params)
    rng = np.random.default_rng(4)
    reqs = [(np.tile(rng.integers(0, 128, 4), 5)[:6 + 3 * i].astype(np.int32)
             if spec else rng.integers(0, 128, (5, 12, 20, 33, 9)[i % 5]),
             (6, 11, 16, 3)[i % 4]) for i in range(6)]

    def run():
        eng = LMEngine(params, 4, 128, n_slots=4, chunk=8, spec_draft=spec,
                       device=cuda_device)
        rids = [eng.submit(p, max_new=g,
                           **(dict(temperature=0.9, top_k=20, seed=i)
                              if sample and i % 2 else {}))
                for i, (p, g) in enumerate(reqs)]
        res = eng.run()
        return [res[r] for r in rids], {k: v for k, v in eng.stats.items()
                                        if k != "wall_s"}

    (got, gstats), (want, wstats), st = _graph_and_eager(run)
    assert got == want and gstats == wstats
    assert st["replays"] > 0 and st["captures"] == st["warmups"]


@pytest.mark.cuda
def test_a_captured_kernel_counts_one_launch_per_replay(cuda_device):
    cf = graphs.CapturedFn(lambda x: ep.class_reduce(x * 1.0), "class_reduce probe")
    x = torch.randn(100, 90, device=cuda_device)
    before = ep.class_reduce.launches
    outs = [cf(x) for _ in range(4)]  # a warm-up (+ capture), three replays
    torch.cuda.synchronize()
    assert ep.class_reduce.launches - before == 4
    want = ep.class_reduce_plain(x)
    assert all(_bits_equal(o, want) for o in outs)
    assert len(cf) == 1


@pytest.mark.cuda
def test_a_host_read_raises_at_capture(cuda_device):
    cf = graphs.CapturedFn(lambda x: x * x.sum().item(), "syncing model")
    with pytest.raises(RuntimeError, match="capture of syncing model"):
        cf(torch.ones(4, device=cuda_device))
    # the stream is left usable
    assert torch.equal((torch.ones(2, device=cuda_device) * 2).cpu(),
                       torch.full((2,), 2.0))
