"""The port's N-input and stream elements against the JAX package, on the CPU.

``nnstreamer_tpu_torch`` ports ``graph/sync.py`` (CollectPads),
``elements/collect_base.py`` and the elements tensor_mux/demux,
tensor_merge/split, tensor_aggregator, tensor_crop, tensor_if, tensor_rate,
tensor_reposink/reposrc and tensor_sparse_enc/dec. Every case here runs the
same seeded numpy inputs through the JAX pipeline and the port's
``Pipeline(device="cpu")`` and compares what reaches the sinks byte for
byte: each buffer's tensors (shape, dtype, bytes), PTS, duration and
offset, and the buffer counts; a failing configuration must fail in both.

Pipelines with one source are deterministic. Two streaming threads meeting
in a collecting element are not (which pad's buffer arrives first depends
on the threads), so the four sync policies are held by driving the element
from one thread in a seeded interleaving of two (or three) stamped streams
and their EOS events, identically in both packages: the emitted sets, their
PTS and the number of EOS events forwarded (exactly one) must agree. The
threaded runs of tests/test_sync_sweep.py are mirrored on the port with
that file's own assertions.

The cases mirror tests/test_stream_elements.py, tests/test_sync_sweep.py,
tests/test_crop_demux_sweep.py, tests/test_if_sweep.py and the crop →
``bucket=4,resize=4:4`` filter contract of tests/test_filter.py (held bit
for bit against the JAX filter run op by op, ``jax.disable_jit``, as
tests/test_torch_filter_options.py explains). The sparse wire blob is
compared byte for byte. Every pipeline runs under a timeout, so a hung
element fails its test instead of stalling the suite.
"""

import time
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import nnstreamer_tpu.core as jcore  # noqa: E402
import nnstreamer_tpu.elements.cond as jcond  # noqa: E402
import nnstreamer_tpu.elements.repo as jrepo  # noqa: E402
import nnstreamer_tpu.elements.sparse as jsparse  # noqa: E402
import nnstreamer_tpu.graph as jgraph  # noqa: E402
import nnstreamer_tpu_torch.core as tcore  # noqa: E402
import nnstreamer_tpu_torch.elements.cond as tcond  # noqa: E402
import nnstreamer_tpu_torch.elements.repo as trepo  # noqa: E402
import nnstreamer_tpu_torch.elements.sparse as tsparse  # noqa: E402
import nnstreamer_tpu_torch.graph as tgraph  # noqa: E402
from nnstreamer_tpu_torch.core import data as tdata  # noqa: E402
from nnstreamer_tpu_torch.utils import native as tnative  # noqa: E402

MS = 1_000_000
TIMEOUT = 60

#: one package's API, so each case is written once
JAX = SimpleNamespace(name="jax", core=jcore, graph=jgraph, cond=jcond,
                      repo=jrepo, sparse=jsparse, kw={})
PORT = SimpleNamespace(name="torch", core=tcore, graph=tgraph, cond=tcond,
                       repo=trepo, sparse=tsparse, kw={"device": "cpu"})


def caps_of(ns, dims, types, rate=30):
    return ns.core.Caps.tensors(ns.core.TensorsConfig(
        ns.core.TensorsInfo.from_strings(dims, types), rate))


def flex_caps(ns, rate=30):
    return ns.core.Caps.tensors(ns.core.TensorsConfig(
        ns.core.TensorsInfo((), ns.core.TensorFormat.FLEXIBLE), rate))


def pipeline(ns):
    return ns.graph.Pipeline(**ns.kw)


def buf(ns, arrays, **kw):
    return ns.core.Buffer.from_arrays(list(arrays), **kw)


def stamped(ns, values, period_ns, jitter_ns=0, seed=0, shape=(2,)):
    """tests/test_sync_sweep.py's streams: PTS = i*period + jitter."""
    rng = np.random.default_rng(seed)
    out = []
    for i, v in enumerate(values):
        j = int(rng.integers(-jitter_ns, jitter_ns + 1)) if jitter_ns else 0
        out.append(buf(ns, [np.full(shape, v, np.float32)],
                       pts=max(0, i * period_ns + j), duration=period_ns))
    return out


def record(sink):
    """What reached a sink: per buffer, its timestamps and each tensor's
    shape, dtype and bytes."""
    out = []
    for b in sink.buffers:
        mems = []
        for m in b.memories:
            a = np.asarray(m.host())
            mems.append((a.shape, a.dtype.str, np.ascontiguousarray(a).tobytes()))
        out.append((b.pts, b.duration, b.offset, mems))
    return out


def run_both(case, *args, **kw):
    """``case(ns, *args, **kw) -> {key: sink}`` on both packages; the
    records must be equal. Returns the port's sinks."""
    got = {}
    for ns in (JAX, PORT):
        sinks = case(ns, *args, **kw)
        got[ns.name] = ({k: record(s) for k, s in sinks.items()}, sinks)
    assert got["torch"][0] == got["jax"][0]
    return got["torch"][1]


def fails_in_both(case, match, *args, **kw):
    for ns in (JAX, PORT):
        with pytest.raises((ns.graph.PipelineError, ValueError), match=match):
            case(ns, *args, **kw)


def arr_seq(n, shape, dtype=np.float32, scale=1):
    return [np.full(shape, i * scale, dtype) for i in range(n)]


# --------------------------------------------------------------------------- #
# tensor_mux / tensor_demux
# --------------------------------------------------------------------------- #

def mux_streams(ns, streams, sync_mode="slowest", sync_option="", **src_kw):
    p = pipeline(ns)
    mux = p.add_new("tensor_mux", sync_mode=sync_mode, sync_option=sync_option)
    for caps, data in streams:
        src = p.add_new("appsrc", caps=caps_of(ns, *caps), data=data(ns), **src_kw)
        ns.graph.Pipeline.link(src, mux)
    sink = p.add_new("tensor_sink", store=True)
    ns.graph.Pipeline.link(mux, sink)
    p.run(timeout=TIMEOUT)
    return {"sink": sink}


MUX_CASES = {
    # test_stream_elements.TestMux: equal rates, so any arrival order pairs alike
    "two_streams": ([(("4", "float32"), lambda ns: arr_seq(3, (4,))),
                     (("2", "float32"), lambda ns: arr_seq(3, (2,), scale=10))],
                    "slowest"),
    "eos_when_one_stream_shorter": (
        [(("4", "float32"), lambda ns: arr_seq(5, (4,))),
         (("2", "float32"), lambda ns: arr_seq(2, (2,)))], "slowest"),
    # test_sync_sweep.TestMuxPolicies.test_nosync_pairs_in_arrival_order
    "nosync_arrival_order": (
        [(("2", "float32"), lambda ns: stamped(ns, range(5), 33 * MS)),
         (("2", "float32"), lambda ns: stamped(ns, range(10, 15), 100 * MS))],
        "nosync"),
    "three_pads_equal_rate": (
        [(("2", "float32"), lambda ns: stamped(ns, range(4), 33 * MS)),
         (("3", "int16"), lambda ns: [buf(ns, [np.full(3, i, np.int16)],
                                          pts=i * 33 * MS) for i in range(4)]),
         (("1", "uint8"), lambda ns: [buf(ns, [np.full(1, 9 - i, np.uint8)],
                                          pts=i * 33 * MS) for i in range(4)])],
        "slowest"),
}


@pytest.mark.parametrize("name", sorted(MUX_CASES))
def test_mux_pipeline_matches_jax(name):
    streams, mode = MUX_CASES[name]
    sinks = run_both(mux_streams, streams, mode)
    frames = sinks["sink"].buffers
    assert frames and all(b.num_tensors == len(streams) for b in frames)


def test_mux_frame_config_and_meta_union():
    sinks = run_both(mux_streams, MUX_CASES["two_streams"][0], "slowest")
    frame = sinks["sink"].buffers[1]
    assert frame.config.info.num_tensors == 2
    np.testing.assert_array_equal(frame.memories[1].host(), np.full((2,), 10))


def demux(ns, tensorpick, n_pads):
    p = pipeline(ns)
    frames = [buf(ns, [np.full((2,), 10 * t + i, np.float32) for i in range(4)],
                  pts=t * 33 * MS) for t in range(3)]
    src = p.add_new("appsrc", caps=caps_of(ns, "2,2,2,2", "float32,float32,"
                                           "float32,float32"), data=frames)
    d = p.add_new("tensor_demux", tensorpick=tensorpick)
    sinks = [p.add_new("tensor_sink", store=True) for _ in range(n_pads)]
    ns.graph.Pipeline.link(src, d)
    for s in sinks:
        ns.graph.Pipeline.link(d, s)
    p.run(timeout=TIMEOUT)
    return dict(enumerate(sinks))


@pytest.mark.parametrize("pick,n_pads", [
    (None, 4), ("2", 1), ("0,2", 2), ("0:1,3", 2), ("0,1:2", 2), ("3:0,1,2", 3)])
def test_demux_tensorpick_matches_jax(pick, n_pads):
    sinks = run_both(demux, pick, n_pads)
    groups = [[int(x) for x in g.split(":")] for g in pick.split(",")] if pick \
        else [[i] for i in range(4)]
    for i, grp in enumerate(groups):
        b = sinks[i].buffers[0]
        assert [float(m.host()[0]) for m in b.memories] == [float(j) for j in grp]


def test_demux_refuses_a_pick_the_pads_do_not_fit():
    fails_in_both(demux, "outputs configured", "0,1,2", 2)


# --------------------------------------------------------------------------- #
# the four sync policies, driven from one thread in a seeded interleaving
# --------------------------------------------------------------------------- #

def drive(ns, kind, props, streams, caps, order):
    """``kind`` (tensor_mux or tensor_merge) fed by one feeder element per
    stream, from this thread: ``order`` is the interleaving, each entry a
    stream index (its next buffer) or ``("eos", i)``. Returns the sink and
    the number of EOS events it received."""
    el = ns.graph.make_element(kind, **props)
    sink = ns.graph.make_element("tensor_sink", store=True)
    feeders = []
    for i, _ in enumerate(streams):
        f = ns.graph.Element(f"feed{i}")
        f.add_src_pad()
        f.src_pad.link(el.free_sink_pad())
        feeders.append(f)
    el.free_src_pad().link(sink.sink_pad)
    eos = []
    sink.on_eos = lambda: eos.append(1)
    sink.start()
    el.start()
    for f in feeders:
        f.send_caps(caps_of(ns, *caps))
    pos = [0] * len(streams)
    for step in order:
        if isinstance(step, tuple):
            feeders[step[1]].push_event_all(ns.graph.Event.eos())
        else:
            feeders[step].push(streams[step][pos[step]])
            pos[step] += 1
    return sink, len(eos)


def interleave(lengths, seed):
    """A seeded random merge of the streams' buffers, each stream's EOS
    right after its last buffer."""
    rng = np.random.default_rng(seed)
    left = [list(range(n)) + ["eos"] for n in lengths]
    order = []
    while any(left):
        i = int(rng.choice([k for k, q in enumerate(left) if q]))
        tok = left[i].pop(0)
        order.append(("eos", i) if tok == "eos" else i)
    return order


def policy_streams(ns, seed):
    """test_sync_sweep's rate mismatch with jitter: ~30 Hz, 10 Hz, 20 Hz."""
    return [stamped(ns, range(12), 33 * MS, jitter_ns=5 * MS, seed=seed),
            stamped(ns, range(100, 104), 100 * MS, jitter_ns=5 * MS, seed=seed + 1),
            stamped(ns, range(200, 206), 50 * MS, seed=seed + 2)]


POLICIES = [("nosync", ""), ("slowest", ""), ("basepad", "0:40000000"),
            ("basepad", "1:20000000"), ("refresh", "")]


@pytest.mark.parametrize("mode,option", POLICIES)
@pytest.mark.parametrize("kind", ["tensor_mux", "tensor_merge"])
@pytest.mark.parametrize("n_pads,seed", [(2, 0), (2, 1), (3, 2), (3, 3)])
def test_sync_policy_interleaving_matches_jax(kind, mode, option, n_pads, seed):
    def case(ns):
        streams = policy_streams(ns, seed)[:n_pads]
        order = interleave([len(s) for s in streams], seed)
        props = {"sync_mode": mode, "sync_option": option}
        if kind == "tensor_merge":  # its basepad is always pad 0, no window
            props["option"] = "first"
        sink, n_eos = drive(ns, kind, props, streams, ("2", "float32"), order)
        assert n_eos == 1, f"{ns.name}: EOS forwarded {n_eos} times"
        return {"sink": sink}

    sinks = run_both(case)
    pts = [b.pts for b in sinks["sink"].buffers]
    assert pts, "no set was emitted"
    if mode != "refresh":
        assert pts == sorted(pts)


def test_sync_eos_early_drains_and_ends_once():
    """One pad ends first: the sets still completable are emitted, then
    exactly one EOS, in both packages."""
    def case(ns):
        streams = [stamped(ns, range(6), 33 * MS), stamped(ns, range(2), 33 * MS)]
        order = [0, 0, 0, 1, ("eos", 1), 0, 1, 0, 0, ("eos", 0)]
        sink, n_eos = drive(ns, "tensor_mux", {"sync_mode": "slowest"}, streams,
                            ("2", "float32"), order)
        assert n_eos == 1
        return {"sink": sink}

    sinks = run_both(case)
    assert sinks["sink"].num_buffers == 1


# threaded: tests/test_sync_sweep.py's assertions, on the port

def port_mux(fast, slow, sync_mode, sync_option=""):
    return mux_streams(PORT, [(("2", "float32"), lambda ns: fast),
                              (("2", "float32"), lambda ns: slow)],
                       sync_mode, sync_option)["sink"]


def test_threaded_slowest_rate_mismatch():
    sink = port_mux(stamped(PORT, range(12), 33 * MS),
                    stamped(PORT, range(100, 104), 100 * MS), "slowest")
    assert 3 <= sink.num_buffers <= 5
    for b in sink.buffers:
        f, s = b.memories[0].host()[0], b.memories[1].host()[0]
        assert f == pytest.approx(min(int(s - 100) * 3, 11), abs=1)


def test_threaded_slowest_with_jitter_monotonic_pts():
    sink = port_mux(stamped(PORT, range(30), 33 * MS, jitter_ns=5 * MS, seed=1),
                    stamped(PORT, range(10), 100 * MS, jitter_ns=5 * MS, seed=2),
                    "slowest")
    pts = [b.pts for b in sink.buffers]
    assert pts == sorted(pts) and sink.num_buffers >= 8


def test_threaded_basepad_window_pairing():
    sink = port_mux(stamped(PORT, range(6), 100 * MS),
                    stamped(PORT, range(50, 68), 33 * MS), "basepad", "0:40000000")
    assert sink.num_buffers >= 4
    assert {b.pts for b in sink.buffers} <= {i * 100 * MS for i in range(6)}


def test_threaded_refresh_reuses_stale_pad():
    sink = port_mux(stamped(PORT, range(3), 200 * MS),
                    stamped(PORT, range(20, 29), 33 * MS), "refresh")
    assert sink.num_buffers >= 9
    assert all(b.num_tensors == 2 for b in sink.buffers)


def test_collectpads_policies_match_jax_unit():
    """CollectPads alone (graph/sync.py), same pushes in both packages."""
    def sets(ns, policy):
        cp = ns.graph.CollectPads(["a", "b"], ns.graph.SyncPolicy.parse(policy),
                                  base_duration_ns=10 * MS)
        out = []
        a, b = stamped(ns, range(5), 30 * MS), stamped(ns, range(9, 12), 70 * MS)
        for key, bb in [("a", a[0]), ("a", a[1]), ("b", b[0]), ("a", a[2]),
                        ("a", a[3]), ("b", b[1]), ("b", b[2]), ("a", a[4])]:
            out += [(sorted((k, float(v.memories[0].host()[0])) for k, v in s.items()),
                     pts) for s, pts in cp.push(key, bb)]
        out += [("eos", cp.set_eos("a"), cp.exhausted)]
        return out

    for policy in ("nosync", "slowest", "basepad", "refresh"):
        assert sets(PORT, policy) == sets(JAX, policy), policy


# --------------------------------------------------------------------------- #
# tensor_merge / tensor_split
# --------------------------------------------------------------------------- #

def merge(ns, shapes, option, dtypes=("float32", "float32"), mode="slowest"):
    p = pipeline(ns)
    mrg = p.add_new("tensor_merge", mode="linear", option=option, sync_mode=mode)
    for k, (shape, dt) in enumerate(zip(shapes, dtypes)):
        dims = ":".join(str(d) for d in reversed(shape))
        data = [buf(ns, [(np.arange(np.prod(shape)) + 100 * k + 10 * i)
                         .reshape(shape).astype(dt)], pts=i * 100 * MS,
                    duration=100 * MS) for i in range(3)]
        src = p.add_new("appsrc", caps=caps_of(ns, dims, dt), data=data)
        ns.graph.Pipeline.link(src, mrg)
    sink = p.add_new("tensor_sink", store=True)
    ns.graph.Pipeline.link(mrg, sink)
    p.run(timeout=TIMEOUT)
    return {"sink": sink}


@pytest.mark.parametrize("shapes,option,out", [
    (((2, 2), (2, 3)), "first", (2, 5)),        # TestMerge.test_concat_innermost
    (((2,), (2,)), "first", (4,)),              # test_merge_concat_first_with_sync
    (((3, 2), (3, 2)), "second", (6, 2)),       # test_merge_concat_second_axis
    (((1, 4, 4, 3), (1, 4, 4, 1)), "0", (1, 4, 4, 4)),
    (((1, 2, 4, 3), (1, 3, 4, 3)), "2", (1, 5, 4, 3)),
    (((2, 4, 4, 3), (1, 4, 4, 3)), "fourth", (3, 4, 4, 3)),
])
def test_merge_matches_jax(shapes, option, out):
    sinks = run_both(merge, shapes, option)
    assert sinks["sink"].num_buffers == 3
    assert sinks["sink"].buffers[0].memories[0].host().shape == out
    assert sinks["sink"].buffers[0].config.info[0].shape == out


def test_merge_dtype_mismatch_fails_in_both():
    fails_in_both(merge, "dtype", ((2,), (2,)), "first", ("float32", "int32"))


def test_merge_rank_mismatch_fails_in_both():
    fails_in_both(merge, "dimension", ((2,), (3, 2)), "first")


def split(ns, arr, tensorseg, option="0", n=None):
    p = pipeline(ns)
    dims = ":".join(str(d) for d in reversed(arr.shape))
    src = p.add_new("appsrc", caps=caps_of(ns, dims, arr.dtype.name),
                    data=[arr, arr + 1])
    sp = p.add_new("tensor_split", tensorseg=tensorseg, option=option)
    sinks = [p.add_new("tensor_sink", store=True)
             for _ in range(n or len(tensorseg.split(",")))]
    ns.graph.Pipeline.link(src, sp)
    for s in sinks:
        ns.graph.Pipeline.link(sp, s)
    p.run(timeout=TIMEOUT)
    return dict(enumerate(sinks))


SPLIT_IN = np.arange(60, dtype=np.float32).reshape(1, 3, 4, 5)


@pytest.mark.parametrize("arr,seg,option", [
    (np.arange(10, dtype=np.float32).reshape(2, 5), "2,3", "0"),
    (np.arange(12, dtype=np.float32).reshape(1, 12), "3,4,5", "0"),
    (SPLIT_IN, "1,4", "0"),
    (SPLIT_IN, "2,2", "1"),
    (SPLIT_IN, "1,1,1", "2"),
    (SPLIT_IN.astype(np.int16), "5:4,5:4:2", "0"),      # reference grammar
    (SPLIT_IN[:, :, :, ::2], "3:4:2,3:4", "0"),         # a strided input
    (SPLIT_IN.transpose(0, 3, 2, 1), "1:2:1:1,58", "0"),
])
def test_split_matches_jax(arr, seg, option):
    sinks = run_both(split, arr, seg, option)
    flat = np.concatenate([s.buffers[0].memories[0].host().reshape(-1)
                           for s in sinks.values()])
    if ":" in seg:  # contiguous regions of the raster, in order
        np.testing.assert_array_equal(flat, np.ascontiguousarray(arr).reshape(-1))


@pytest.mark.parametrize("seg,match", [("2,2", "tensorseg"), ("2:2,2:2", "tensorseg")])
def test_split_bad_segments_fail_in_both(seg, match):
    fails_in_both(split, match, np.zeros((2, 5), np.float32), seg, "0", 2)


# --------------------------------------------------------------------------- #
# tensor_aggregator
# --------------------------------------------------------------------------- #

def aggregate(ns, n, shape, dims, **props):
    p = pipeline(ns)
    src = p.add_new("appsrc", caps=caps_of(ns, dims, "float32"),
                    data=[np.arange(np.prod(shape), dtype=np.float32)
                          .reshape(shape) + 100 * i for i in range(n)],
                    framerate=30)
    agg = p.add_new("tensor_aggregator", **props)
    sink = p.add_new("tensor_sink", store=True)
    ns.graph.Pipeline.link(src, agg, sink)
    p.run(timeout=TIMEOUT)
    return {"sink": sink}


@pytest.mark.parametrize("n,shape,dims,props,count", [
    (8, (1, 3), "3:1", dict(frames_out=4, frames_dim=1), 2),
    (5, (1, 1), "1:1", dict(frames_out=3, frames_flush=1, frames_dim=1), 3),
    (6, (2, 3), "3:2", dict(frames_in=2, frames_out=3, frames_flush=2,
                            frames_dim=1), 5),
    (7, (1, 4, 4, 3), "3:4:4:1", dict(frames_out=2, frames_dim=3), 3),
    (6, (1, 4, 4, 3), "3:4:4:1", dict(frames_out=4, frames_flush=3,
                                      frames_dim=3), 1),
    (5, (2, 2), "2:2", dict(frames_in=2, frames_out=2, frames_dim=0), 5),
])
def test_aggregator_matches_jax(n, shape, dims, props, count):
    sinks = run_both(aggregate, n, shape, dims, **props)
    assert sinks["sink"].num_buffers == count


def test_aggregator_sliding_window_values():
    sinks = run_both(aggregate, 5, (1, 1), "1:1",
                     frames_out=3, frames_flush=1, frames_dim=1)
    windows = [tuple(b.memories[0].host().reshape(-1)) for b in sinks["sink"].buffers]
    assert windows == [(0, 100, 200), (100, 200, 300), (200, 300, 400)]
    pts = [b.pts for b in sinks["sink"].buffers]
    assert pts == [i * 33333333 for i in range(3)]  # each window's first frame


# --------------------------------------------------------------------------- #
# tensor_crop (and crop → bucketed filter)
# --------------------------------------------------------------------------- #

IMG = np.random.default_rng(0).integers(0, 255, (16, 20, 3)).astype(np.uint8)


def crop(ns, img, boxes_per_frame, raw_4d=True, box_dtype=np.int32):
    p = pipeline(ns)
    h, w, c = img.shape
    n = len(boxes_per_frame)
    raw = p.add_new("appsrc", caps=caps_of(ns, f"{c}:{w}:{h}:1" if raw_4d
                                           else f"{c}:{w}:{h}", "uint8"),
                    data=[buf(ns, [img[None] if raw_4d else img], pts=i * 33 * MS,
                              duration=33 * MS) for i in range(n)])
    info = p.add_new("appsrc", caps=flex_caps(ns),
                     data=[buf(ns, [np.asarray(b, box_dtype).reshape(-1, 4)],
                               pts=i * 33 * MS, duration=33 * MS)
                           for i, b in enumerate(boxes_per_frame)])
    cr = p.add_new("tensor_crop")
    sink = p.add_new("tensor_sink", store=True)
    ns.graph.Pipeline.link(raw, cr)      # raw pad
    ns.graph.Pipeline.link(info, cr)     # info pad
    ns.graph.Pipeline.link(cr, sink)
    p.run(timeout=TIMEOUT)
    return {"sink": sink}


CROP_CASES = {
    "multi_region": ([[[2, 3, 5, 4], [0, 0, 20, 16]]], {}),
    "out_of_bounds_clipped": ([[[18, 14, 10, 10]]], {}),
    "negative_origin_clipped": ([[[-3, -2, 6, 5]]], {}),
    "region_counts_vary": ([[[0, 0, 4, 4]],
                            [[0, 0, 4, 4], [4, 4, 4, 4], [8, 8, 4, 4]]], {}),
    "empty_regions_dropped": ([[[5, 5, 0, 3], [1, 1, 2, 2], [25, 2, 4, 4]]], {}),
    "frame_with_no_region_emits_nothing": ([[[0, 0, 2, 2]], [[3, 3, 0, 0]],
                                            [[1, 2, 3, 4]]], {}),
    "raw_3d": ([[[1, 2, 3, 4]]], {"raw_4d": False}),
    "float_boxes_cast": ([[[1.7, 2.2, 3.9, 4.5]]], {"box_dtype": np.float32}),
}


@pytest.mark.parametrize("name", sorted(CROP_CASES))
def test_crop_matches_jax(name):
    boxes, kw = CROP_CASES[name]
    sinks = run_both(crop, IMG, boxes, **kw)
    b0 = sinks["sink"].buffers[0]
    x, y, w, h = (int(v) for v in np.asarray(boxes[0][0], np.float64).astype(np.int64))
    if name in ("multi_region", "region_counts_vary", "raw_3d", "float_boxes_cast"):
        np.testing.assert_array_equal(b0.memories[0].host(), IMG[y:y + h, x:x + w])


def _region_max(x):  # (B, H, W, C) -> (B, C), exact on both packages
    if isinstance(x, torch.Tensor):
        return x.amax(dim=(1, 2))
    return x.max(axis=(1, 2))


def crop_bucketed(ns, frames, custom, model=_region_max):
    """tests/test_filter.py TestBucketedInvoke: tensor_crop →
    tensor_filter custom="bucket=4,..." → sink."""
    img = np.arange(12 * 12 * 2, dtype=np.float32).reshape(1, 12, 12, 2)
    p = pipeline(ns)
    raw = p.add_new("appsrc", caps=caps_of(ns, "2:12:12:1", "float32"),
                    data=[img] * len(frames), framerate=30)
    info = p.add_new("appsrc", caps=flex_caps(ns), data=frames, framerate=30)
    cr = p.add_new("tensor_crop")
    filt = p.add_new("tensor_filter", framework="xla-tpu", model=model,
                     custom=custom)
    sink = p.add_new("tensor_sink", store=True)
    ns.graph.Pipeline.link(raw, cr)
    ns.graph.Pipeline.link(info, cr)
    ns.graph.Pipeline.link(cr, filt, sink)
    # the JAX filter op by op: its invoke runs on the pipeline's thread, which
    # a thread-local jax.disable_jit() would not reach
    jax.config.update("jax_disable_jit", True)
    try:
        p.run(timeout=TIMEOUT)
    finally:
        jax.config.update("jax_disable_jit", False)
    return {"sink": sink}


def test_crop_to_bucketed_filter_matches_jax():
    frames = [np.array([[0, 0, 4, 4], [2, 2, 4, 4], [1, 1, 8, 8]], np.int32),
              np.array([[0, 0, 4, 4]], np.int32),
              np.array([[3, 1, 5, 7], [0, 0, 12, 12], [6, 6, 2, 3], [1, 9, 9, 2],
                        [0, 0, 1, 1]], np.int32)]
    sinks = run_both(crop_bucketed, frames, "bucket=4,resize=4:4")
    outs = [b.memories[0].host() for b in sinks["sink"].buffers]
    assert [o.shape for o in outs] == [(3, 2), (1, 2), (5, 2)]
    np.testing.assert_array_equal(outs[1][0], outs[0][0])


def test_crop_mixed_shapes_without_resize_fails_in_both():
    frames = [np.array([[0, 0, 2, 2], [0, 0, 4, 4]], np.int32)]
    fails_in_both(crop_bucketed, "same-shape", frames, "bucket=4", lambda x: x)


# --------------------------------------------------------------------------- #
# tensor_if
# --------------------------------------------------------------------------- #

VALUES = [2.0, 5.0, 6.0, 7.0, 9.0]
IF_OPS = {"EQ": "5", "NE": "5", "GT": "5", "GE": "5", "LT": "5", "LE": "5",
          "RANGE_INCLUSIVE": "5:7", "RANGE_EXCLUSIVE": "5:7",
          "NOT_IN_RANGE_INCLUSIVE": "5:7", "NOT_IN_RANGE_EXCLUSIVE": "5:7"}


def tensor_if(ns, frames, dims, types, else_pass=False, **props):
    p = pipeline(ns)
    src = p.add_new("appsrc", caps=caps_of(ns, dims, types), data=frames)
    tif = p.add_new("tensor_if", **props)
    s_then = p.add_new("tensor_sink", store=True)
    ns.graph.Pipeline.link(src, tif)
    tif.src_pads[0].link(s_then.sink_pad)
    sinks = {"then": s_then}
    if else_pass:
        tif.set_properties(**{"else": "PASSTHROUGH"})
        tif.add_src_pad("src_else")
        sinks["else"] = p.add_new("tensor_sink", store=True)
        tif.src_pads[1].link(sinks["else"].sink_pad)
    p.run(timeout=TIMEOUT)
    return sinks


@pytest.mark.parametrize("else_pass", [False, True])
@pytest.mark.parametrize("op", sorted(IF_OPS))
def test_if_operator_matches_jax(op, else_pass):
    """tests/test_if_sweep.py's operator table, then and else branches."""
    frames = [np.full(1, v, np.float32) for v in VALUES]
    sinks = run_both(tensor_if, frames, "1", "float32", else_pass,
                     compared_value="TENSOR_AVERAGE_VALUE",
                     compared_value_option="0", operator=op,
                     supplied_value=IF_OPS[op],
                     then="SKIP" if else_pass else "PASSTHROUGH")
    if else_pass:
        assert sinks["then"].num_buffers == 0


@pytest.mark.parametrize("name,frames,dims,types,props", [
    ("average_gate", [np.full(4, v, np.float32) for v in [1, 9, 2, 8]], "4", "float32",
     dict(compared_value="TENSOR_AVERAGE_VALUE", operator="GT", supplied_value="5")),
    ("a_value_flat", [np.array([0, 5, 0, 0], np.float32),
                      np.array([0, 1, 0, 0], np.float32)], "4", "float32",
     dict(compared_value="A_VALUE", compared_value_option="1:0", operator="GE",
          supplied_value="5")),
    ("a_value_innermost_first", [np.where(np.arange(6).reshape(2, 3) == 5, 8.0,
                                          0.0).astype(np.float32),
                                 np.zeros((2, 3), np.float32)], "3:2", "float32",
     dict(compared_value="A_VALUE", compared_value_option="2:1:0",
          operator="GT", supplied_value="5")),
    ("average_int_mean_float64", [np.full((3, 3), v, np.uint8) for v in
                                  (0, 127, 128, 255)], "3:3", "uint8",
     dict(compared_value="TENSOR_AVERAGE_VALUE", operator="GE",
          supplied_value="127.5")),
    ("average_of_second_tensor", [(np.zeros(2, np.float32), np.full(3, v, np.int32))
                                  for v in (-4, 4, 1)], "2,3", "float32,int32",
     dict(compared_value="TENSOR_AVERAGE_VALUE", compared_value_option="1",
          operator="RANGE_INCLUSIVE", supplied_value="-1:2")),
])
def test_if_compared_values_match_jax(name, frames, dims, types, props):
    run_both(tensor_if, frames, dims, types, **props)


def test_if_tensorpick_then_action_matches_jax():
    frames = [(np.full(2, v, np.float32), np.full(3, -v, np.float32)) for v in (1.0, 9.0)]
    sinks = run_both(tensor_if, frames, "2,3", "float32,float32",
                     compared_value="TENSOR_AVERAGE_VALUE", operator="GT",
                     supplied_value="5", then="TENSORPICK", then_option="1")
    assert sinks["then"].num_buffers == 1
    assert sinks["then"].buffers[0].num_tensors == 1


def test_if_custom_predicate_matches_jax():
    def case(ns):
        ns.cond.register_if_custom("evens", lambda b: b.offset % 2 == 0)
        try:
            return tensor_if(ns, arr_seq(4, (2,)), "2", "float32",
                             compared_value="CUSTOM", compared_value_option="evens")
        finally:
            ns.cond.unregister_if_custom("evens")

    assert run_both(case)["then"].num_buffers == 2


@pytest.mark.parametrize("bad", [
    dict(operator="BOGUS", supplied_value="5"),
    dict(operator="GT", supplied_value="not-a-number"),
    dict(compared_value="NOPE", operator="GT", supplied_value="5"),
    dict(compared_value="CUSTOM", compared_value_option="unregistered"),
])
def test_if_invalid_config_fails_in_both(bad):
    props = dict(compared_value="TENSOR_AVERAGE_VALUE", compared_value_option="0")
    props.update(bad)
    for ns in (JAX, PORT):
        with pytest.raises((ns.graph.PipelineError, ValueError, KeyError)):
            tensor_if(ns, [np.zeros(1, np.float32)], "1", "float32", **props)


def test_average_on_a_tensor_reduces_where_it_lies():
    """core.data.tensor_average: numpy's float64 mean for host arrays (the
    JAX package's arithmetic); a tensor is reduced in float64 where it lies
    and only the scalar read back. Integer-valued data gives the same mean
    both ways."""
    rng = np.random.default_rng(4)
    for arr in (rng.integers(0, 256, (37, 41, 3)).astype(np.uint8),
                rng.integers(-1000, 1000, 5000).astype(np.float32)):
        want = float(np.mean(arr, dtype=np.float64))
        assert tdata.tensor_average(arr) == want
        assert tdata.tensor_average(torch.from_numpy(arr)) == want
    x = rng.standard_normal(10_000).astype(np.float32)
    assert tdata.tensor_average(torch.from_numpy(x)) == pytest.approx(
        float(np.mean(x, dtype=np.float64)), rel=1e-12, abs=1e-15)


# --------------------------------------------------------------------------- #
# tensor_rate
# --------------------------------------------------------------------------- #

def rate(ns, n, src_rate, **props):
    p = pipeline(ns)
    src = p.add_new("appsrc", caps=caps_of(ns, "2", "float32", src_rate),
                    data=arr_seq(n, (2,)), framerate=src_rate)
    r = p.add_new("tensor_rate", **props)
    sink = p.add_new("tensor_sink", store=True)
    ns.graph.Pipeline.link(src, r, sink)
    p.run(timeout=TIMEOUT)
    return sink, (r.n_in, r.n_out, r.n_dup, r.n_drop)


@pytest.mark.parametrize("n,src_rate,props", [
    (10, 30, dict(framerate="10/1", throttle=False)),          # downsample
    (6, 10, dict(framerate="30/1", throttle=False)),           # duplicate
    (9, 30, dict(framerate="15/2", throttle=False, drop=False)),
    (8, 25, dict(framerate="25/1", throttle=False)),
])
def test_rate_matches_jax(n, src_rate, props):
    got = {ns.name: rate(ns, n, src_rate, **props) for ns in (JAX, PORT)}
    assert record(got["torch"][0]) == record(got["jax"][0])
    assert got["torch"][1] == got["jax"][1]


def test_rate_throttle_qos_reaches_the_filter():
    """test_stream_elements.TestRate.test_throttle_qos_reaches_filter: the
    QoS event cuts the port filter's invokes as it cuts the JAX filter's."""
    invokes = {}
    for ns in (JAX, PORT):
        p = pipeline(ns)
        src = p.add_new("appsrc", caps=caps_of(ns, "2", "float32"),
                        data=arr_seq(6, (2,)), framerate=30)
        filt = p.add_new("tensor_filter", model=lambda x: x)
        r = p.add_new("tensor_rate", framerate="10/1", throttle=True)
        sink = p.add_new("tensor_sink", store=True)
        ns.graph.Pipeline.link(src, filt, r, sink)
        p.run(timeout=TIMEOUT)
        assert filt._throttle_interval_ns == 100_000_000
        invokes[ns.name] = (filt.stats.total_invoke_num, record(sink))
    assert invokes["torch"] == invokes["jax"] and invokes["torch"][0] < 6


def test_rate_bad_framerate_fails_in_both():
    fails_in_both(rate, "framerate", 3, 30, framerate="ten")


# --------------------------------------------------------------------------- #
# tensor_reposink / tensor_reposrc
# --------------------------------------------------------------------------- #

def repo_loop(ns, frames, slot, model, state_dims="2", state_types="float32"):
    """mux(input, state) → filter → tee → [queue → sink], [queue →
    reposink]; reposrc feeds the state back (TestRepoLoop)."""
    ns.repo.reset_repo()
    p = pipeline(ns)
    src = p.add_new("appsrc", caps=caps_of(ns, "2", "float32"), data=frames,
                    framerate=30)
    state = p.add_new("tensor_reposrc", slot_index=slot, dims=state_dims,
                      types=state_types)
    mux = p.add_new("tensor_mux", sync_mode="nosync")
    filt = p.add_new("tensor_filter", model=model)
    tee = p.add_new("tee")
    q1, q2 = p.add_new("queue"), p.add_new("queue")
    rsink = p.add_new("tensor_reposink", slot_index=slot)
    sink = p.add_new("tensor_sink", store=True)
    ns.graph.Pipeline.link(src, mux)
    ns.graph.Pipeline.link(state, mux)
    ns.graph.Pipeline.link(mux, filt, tee)
    ns.graph.Pipeline.link(tee, q1, sink)
    ns.graph.Pipeline.link(tee, q2, rsink)
    p.start()
    try:
        deadline = time.monotonic() + TIMEOUT
        while sink.num_buffers < len(frames) and time.monotonic() < deadline:
            time.sleep(0.01)
    finally:
        p.stop()
    assert sink.num_buffers == len(frames), f"{ns.name}: the loop stalled"
    return {"sink": sink}


def test_repo_accumulator_loop_matches_jax():
    frames = [np.full(2, v, np.float32) for v in (1, 2, 3, 4, 5)]
    sinks = run_both(repo_loop, frames, 5, lambda x, h: x + h)
    assert [b.memories[0].host()[0] for b in sinks["sink"].buffers] == [1, 3, 6, 10, 15]


def test_repo_slot_survives_a_rerun():
    """Slots are process-global; a second run over the same slot starts
    from the bootstrap zeros again (reposink/reposrc ``prepare``)."""
    frames = [np.full(2, 1, np.float32)] * 3
    for _ in range(2):
        sinks = repo_loop(PORT, frames, 6, lambda x, h: x + h)
        assert [b.memories[0].host()[0] for b in sinks["sink"].buffers] == [1, 2, 3]


def test_reposrc_caps_string_and_eos():
    """reposrc with a gst caps string; reposink's EOS ends it after the
    bootstrap frame and the frames it received."""
    def case(ns):
        ns.repo.reset_repo()
        p = pipeline(ns)
        src = p.add_new("appsrc", caps=caps_of(ns, "3:2", "int16"),
                        data=[np.full((2, 3), i, np.int16) for i in range(3)])
        rsink = p.add_new("tensor_reposink", slot_index=12)
        rsrc = p.add_new("tensor_reposrc", slot_index=12, caps=(
            "other/tensors,num_tensors=1,dimensions=3:2,types=int16,format=static"))
        sink = p.add_new("tensor_sink", store=True)
        ns.graph.Pipeline.link(src, rsink)
        ns.graph.Pipeline.link(rsrc, sink)
        p.run(timeout=TIMEOUT)
        return {"sink": sink}

    sinks = run_both(case)
    assert [int(b.memories[0].host()[0, 0]) for b in sinks["sink"].buffers] == [0, 0, 1, 2]


# --------------------------------------------------------------------------- #
# tensor_sparse_enc / tensor_sparse_dec
# --------------------------------------------------------------------------- #

def _sparse_arrays():
    rng = np.random.default_rng(7)
    out = []
    for dt in ("float32", "int8", "uint16", "float64", "int32", "uint8"):
        a = np.zeros((6, 5), dt)
        idx = rng.choice(30, 7, replace=False)
        a.reshape(-1)[idx] = rng.integers(1, 100, 7).astype(dt)
        out.append(a)
    z = np.zeros((3, 4), np.float32)
    z[1, 2] = -0.0  # kept by the native codec (its bytes are not zero)
    z[2, 3] = 2.5
    out.append(z)
    out.append(np.zeros((2, 2), np.float32))  # nnz 0
    return out


@pytest.mark.parametrize("i", range(8))
def test_sparse_blob_is_byte_identical_to_jax(i):
    arr = _sparse_arrays()[i]
    jblob = jsparse.sparse_encode(arr, jcore.TensorInfo.from_array(arr))
    tblob = tsparse.sparse_encode(arr, tcore.TensorInfo.from_array(arr))
    assert tblob == jblob
    dec, info = tsparse.sparse_decode(jblob)
    assert dec.dtype == arr.dtype and info.shape == arr.shape
    assert dec.tobytes() == arr.tobytes()


def test_sparse_codec_numpy_path_matches_the_library(monkeypatch):
    """Without g++ the codec runs numpy (the JAX bridge's contract): the
    same blobs but for -0.0, which numpy counts as zero."""
    for arr in _sparse_arrays():
        lib_blob = tsparse.sparse_encode(arr, tcore.TensorInfo.from_array(arr))
        with monkeypatch.context() as m:
            m.setattr(tnative, "get_lib", lambda: None)
            np_blob = tsparse.sparse_encode(arr, tcore.TensorInfo.from_array(arr))
            dec, _ = tsparse.sparse_decode(lib_blob)
        assert np.array_equal(dec, arr)
        if arr.dtype.kind != "f" or not (np.signbit(arr) & (arr == 0)).any():
            assert np_blob == lib_blob


def sparse_pipeline(ns, frames, dims, types):
    p = pipeline(ns)
    src = p.add_new("appsrc", caps=caps_of(ns, dims, types), data=frames)
    enc = p.add_new("tensor_sparse_enc")
    t = p.add_new("tee")
    dec = p.add_new("tensor_sparse_dec")
    wire = p.add_new("tensor_sink", store=True)
    sink = p.add_new("tensor_sink", store=True)
    ns.graph.Pipeline.link(src, enc, t)
    ns.graph.Pipeline.link(t, p.add_new("queue"), wire)
    ns.graph.Pipeline.link(t, p.add_new("queue"), dec, sink)
    p.run(timeout=TIMEOUT)
    return {"wire": wire, "sink": sink}


def test_sparse_pipeline_matches_jax():
    arrs = _sparse_arrays()
    frames = [(arrs[0], arrs[2]), (arrs[0] * 2, arrs[2] * 3)]
    sinks = run_both(sparse_pipeline, frames, "5:6,5:6", "float32,uint16")
    out = sinks["sink"].buffers[1]
    np.testing.assert_array_equal(out.memories[1].host(), arrs[2] * 3)


def test_sparse_compression_ratio():
    dense = np.zeros((100, 100), np.float32)
    dense[0, 0] = 1
    blob = tsparse.sparse_encode(dense, tcore.TensorInfo.from_array(dense))
    assert len(blob) < dense.nbytes // 10


def test_sparse_decode_refuses_a_dense_blob():
    from nnstreamer_tpu_torch.core.meta import TensorMetaInfo

    arr = np.ones(4, np.float32)
    blob = TensorMetaInfo(tcore.TensorInfo.from_array(arr),
                          tcore.TensorFormat.STATIC).pack() + arr.tobytes()
    with pytest.raises(ValueError, match="not a sparse"):
        tsparse.sparse_decode(blob)


def test_native_codec_builds_outside_the_source_tree():
    """With g++ the codec library is built into the package's build
    directory, never beside its source; without g++ there is none and the
    codec runs numpy."""
    import os
    import shutil

    lib = tnative.get_lib()
    if shutil.which("g++") is None:
        assert lib is None
        return
    assert lib is not None
    assert os.path.isfile(tnative._target())
    assert os.path.dirname(tnative._target()) == tnative.BUILD_DIR
    assert not any(n.endswith(".so") and n.startswith("libnns_runtime-")
                   for n in os.listdir(os.path.dirname(tnative.SRC)))
