"""The torch port's front door against the JAX package, on the CPU.

``graph/parse.py`` must build the JAX parser's graphs (element kinds, set
properties, links) from the launch strings of tests/test_launch_sweep.py
that use only ported elements, and refuse its failing strings; the
``nns-launch`` CLI runs them with ``--device cpu``. The README's headline
pipeline (videotestsrc ! tensor_converter ! tensor_transform ! tensor_filter
! tensor_decoder image_labeling ! tensor_sink) at a small MobileNet-v2, with
the JAX bundle's weights carried across by ``models/convert.py``, gives the
JAX pipeline's labels exactly and its logits within the tolerance of the
classification slice's test (float32: rtol 1e-4, atol 1e-4 of the largest
logit), with the transform fused into the filter's invoke and not. Epilogue
fusion of a filter → transform → decoder tail and SingleShot are covered
too.
"""

import dataclasses
import io
import os
import subprocess
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from nnstreamer_tpu.cli import main as jax_cli  # noqa: E402
from nnstreamer_tpu.graph.parse import parse_pipeline as jax_parse  # noqa: E402
from nnstreamer_tpu.models.zoo import get_model as jax_get_model  # noqa: E402
from nnstreamer_tpu_torch.cli import main as port_cli  # noqa: E402
from nnstreamer_tpu_torch.graph import Pipeline  # noqa: E402
from nnstreamer_tpu_torch.graph.parse import (caps_to_gst_string,  # noqa: E402
                                              parse_caps_string, parse_pipeline)
from nnstreamer_tpu_torch.models.convert import from_flax_variables  # noqa: E402
from nnstreamer_tpu_torch.models.mobilenet_v2 import make_mobilenet_v2  # noqa: E402
from nnstreamer_tpu_torch.single import SingleShot  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE, CLASSES = 32, 16
MODEL = (f"zoo://mobilenet_v2?width=0.25&size={SIZE}&num_classes={CLASSES}"
         "&dtype=float32")

#: tests/test_launch_sweep.py's PASS_CASES that use only ported elements,
#: then a string for each N-input and stream element
PASS_CASES = [
    "videotestsrc num-buffers=4 width=16 height=16 ! tensor_converter ! "
    "tensor_sink",
    "videotestsrc num-buffers=4 width=16 height=16 ! tensor_converter ! "
    "queue ! tensor_sink",
    "videotestsrc num-buffers=4 width=16 height=16 ! tensor_converter ! "
    "tensor_transform mode=arithmetic "
    "option=typecast:float32,add:-127.5,div:127.5 ! tensor_sink",
    "videotestsrc num-buffers=4 width=16 height=16 ! tensor_converter ! "
    "tensor_transform mode=transpose option=1:0:2:3 ! tensor_sink",
    "videotestsrc num-buffers=4 width=16 height=16 ! tensor_converter ! "
    "tensor_transform mode=clamp option=10:200 ! tensor_sink",
    f"videotestsrc num-buffers=3 width=32 height=32 ! tensor_converter ! "
    f'tensor_filter framework=xla-tpu model="{MODEL}" ! tensor_sink',
    f"videotestsrc num-buffers=3 width=32 height=32 ! tensor_converter ! "
    f'tensor_filter framework=xla-tpu model="{MODEL}" custom=quant=w8 ! '
    f"tensor_sink",
    f"videotestsrc num-buffers=8 width=32 height=32 ! tensor_converter ! "
    f"tensor_batch max-batch=4 budget-ms=100 ! "
    f'tensor_filter framework=xla-tpu model="{MODEL}&batch=4" ! '
    f"tensor_unbatch ! tensor_sink",
    "videotestsrc num-buffers=4 width=8 height=8 ! tensor_converter ! "
    "tee name=t t. ! queue ! tensor_sink t. ! queue ! tensor_sink",
    # grammar beyond the sweep: caps filters, quoting, named sinks
    "videotestsrc num-buffers=2 ! video/x-raw,format=RGB,width=24,height=8 ! "
    "tensor_converter ! fakesink",
    'audiotestsrc num-buffers=2 samplesperbuffer=64 ! tensor_converter ! '
    'appsink name="pull here"',
    # the N-input and stream elements: one string each, pad references too
    "videotestsrc num-buffers=8 width=8 height=8 ! tensor_converter ! "
    "tensor_aggregator frames_in=1 frames_out=4 frames_flush=4 "
    "frames_dim=3 ! tensor_sink",
    "videotestsrc num-buffers=3 width=8 height=8 ! tensor_converter ! mux.sink_0 "
    "videotestsrc num-buffers=3 width=4 height=4 ! tensor_converter ! mux.sink_1 "
    "tensor_mux name=mux sync-mode=nosync ! tensor_demux name=d tensorpick=1,0 "
    "d.src_0 ! queue ! tensor_sink d.src_1 ! queue ! tensor_sink",
    "videotestsrc num-buffers=3 width=8 height=8 ! tensor_converter ! m.sink_0 "
    "videotestsrc num-buffers=3 width=8 height=8 pattern=gradient ! "
    "tensor_converter ! m.sink_1 tensor_merge name=m option=first "
    "sync-mode=slowest ! tensor_split name=s tensorseg=2,4 "
    "s.src_0 ! tensor_sink s.src_1 ! tensor_sink",
    "tensor_crop name=c ! tensor_sink "
    "videotestsrc num-buffers=2 width=16 height=16 ! tensor_converter ! c. "
    "videotestsrc num-buffers=2 width=4 height=1 pattern=solid color=0x030303 ! "
    "video/x-raw,format=GRAY8 ! tensor_converter ! "
    "tensor_transform mode=typecast option=int32 ! c.",
    "videotestsrc num-buffers=4 width=8 height=8 pattern=random ! tensor_converter ! "
    "tensor_if compared-value=TENSOR_AVERAGE_VALUE compared-value-option=0 "
    "supplied-value=120 operator=GT then=PASSTHROUGH ! tensor_sink",
    "videotestsrc num-buffers=9 width=8 height=8 ! tensor_converter ! "
    "tensor_rate framerate=10/1 throttle=false ! tensor_sink",
    "videotestsrc num-buffers=3 width=8 height=8 ! tensor_converter ! "
    "tensor_reposink slot-index=31 "
    "tensor_reposrc slot-index=31 dims=3:8:8:1 types=uint8 ! tensor_sink",
    "videotestsrc num-buffers=2 width=8 height=8 pattern=solid ! tensor_converter ! "
    "tensor_sparse_enc ! tensor_sparse_dec ! tensor_sink",
]

#: tests/test_launch_sweep.py's FAIL_CASES
FAIL_CASES = [
    "videotestsrc num-buffers=2 ! tensor_bogus ! tensor_sink",
    "videotestsrc num-buffers=2 bogus-prop=1 ! tensor_sink",
    "videotestsrc num-buffers=2 ! tensor_converter ! "
    "tensor_transform mode=nope option=1 ! tensor_sink",
    "videotestsrc num-buffers=2 ! tensor_converter ! "
    "tensor_filter framework=no-such-fw model=x ! tensor_sink",
    "videotestsrc num-buffers=2 ! ! tensor_sink",
]


def _graph(p, caps_str) -> tuple:
    """Elements in encounter order (kind, set properties; a caps filter's
    caps as a gst string) and links between them by position and pad name
    (automatic names count per process, so they are left out)."""
    els = list(p.elements.values())
    pos = {el.name: i for i, el in enumerate(els)}
    nodes = []
    for el in els:
        explicit = sorted(getattr(el, "_parse_explicit", set()))
        props = {k: str(getattr(el, k)) for k in explicit if k != "name"}
        if el.ELEMENT_NAME == "capsfilter":
            props["caps"] = caps_str(el.caps)
        nodes.append((el.ELEMENT_NAME, props))
    links = sorted((pos[el.name], pad.name, pos[pad.peer.element.name], pad.peer.name)
                   for el in els for pad in el.src_pads if pad.peer is not None)
    return nodes, links


@pytest.mark.parametrize("pipeline", PASS_CASES,
                         ids=[f"ok{i}" for i in range(len(PASS_CASES))])
def test_parse_builds_the_jax_graph(pipeline):
    from nnstreamer_tpu.graph.parse import caps_to_gst_string as jax_caps_str

    want = _graph(jax_parse(pipeline), jax_caps_str)
    got = _graph(parse_pipeline(pipeline), caps_to_gst_string)
    assert got == want


#: the cases the CLI runs: every one (custom=quant=w8 of a convolutional
#: zoo model quantizes its flax variables tree, models/quantize.py)
RUN_CASES = list(PASS_CASES)


@pytest.mark.parametrize("pipeline", RUN_CASES,
                         ids=[f"ok{i}" for i in range(len(RUN_CASES))])
def test_cli_runs_the_launch_strings(pipeline):
    assert port_cli(["--device", "cpu", pipeline, "--timeout", "120"]) == 0


@pytest.mark.parametrize("pipeline", FAIL_CASES,
                         ids=[f"bad{i}" for i in range(len(FAIL_CASES))])
def test_cli_refuses_what_jax_refuses(pipeline):
    assert jax_cli([pipeline, "--timeout", "30"]) != 0
    assert port_cli(["--device", "cpu", pipeline, "--timeout", "30"]) != 0


def test_caps_strings_round_trip():
    s = 'other/tensors,format=static,num_tensors=1,dimensions="3:4:5:1",types=uint8'
    caps = parse_caps_string(s)
    assert caps.fields["dims"] == "3:4:5:1" and caps.fields["num"] == 1
    assert parse_caps_string(caps_to_gst_string(caps)).fields == caps.fields


def test_cli_negotiation_error_and_timeout_codes():
    bad = ("videotestsrc num-buffers=2 width=16 height=16 ! tensor_converter ! "
           "tensor_filter framework=xla-tpu model=zoo://passthrough?dims=3:8:8:1 ! "
           "tensor_sink")
    assert jax_cli([bad, "--timeout", "30"]) == 1
    assert port_cli(["--device", "cpu", bad, "--timeout", "30"]) == 1
    endless = "videotestsrc width=8 height=8 ! tensor_converter ! tensor_sink"
    assert port_cli(["--device", "cpu", endless, "--timeout", "1"]) == 2


def test_cli_lists_and_inspects():
    out = io.StringIO()
    with redirect_stdout(out):
        assert port_cli(["--list-elements"]) == 0
        assert port_cli(["--list-models"]) == 0
        assert port_cli(["--inspect", "tensor_transform"]) == 0
        assert port_cli(["--inspect", "tensor_filter"]) == 0
    text = out.getvalue()
    for name in ("tensor_transform", "capsfilter", "appsink", "filesink",
                 "passthrough", "scaler", "average", "matmul", "mobilenet_v2",
                 "transform-chain", "frameworks: ", "torch-cuda", "tensor_mux",
                 "tensor_demux", "tensor_merge", "tensor_split", "tensor_crop",
                 "tensor_aggregator", "tensor_if", "tensor_rate", "tensor_reposink",
                 "tensor_reposrc", "tensor_sparse_enc", "tensor_sparse_dec",
                 "lstm_cell"):
        assert name in text
    assert port_cli(["--inspect", "no_such_element"]) == 1


@pytest.mark.parametrize("flag", [["--device", "cpu", "--deadline-ms", "50"],
                                  ["--device", "cpu",
                                   "--checkpoint-interval", "5"],
                                  ["--role", "prefill"],
                                  ["--device", "cpu", "--backends", "127.0.0.1:1"],
                                  ["--device", "tpu"]])
def test_cli_refuses_unported_flags(flag):
    # combinations the JAX CLI refuses too: --deadline-ms and --backends
    # for a pipeline without a tensor_query_client, --checkpoint-interval
    # without --checkpoint-dir, --role prefill without --kv-page-size
    with pytest.raises(SystemExit) as e:
        port_cli(flag + ["videotestsrc num-buffers=1 ! tensor_sink"])
    assert e.value.code == 2


def test_cli_default_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_cli(["videotestsrc num-buffers=1 ! tensor_converter ! tensor_sink"])


def test_cli_module_entry_point(tmp_path):
    labels = tmp_path / "labels.txt"
    labels.write_text("\n".join(f"l{i}" for i in range(CLASSES)))
    headline = (f"videotestsrc num-buffers=2 width={SIZE} height={SIZE} ! "
                f"tensor_converter ! tensor_transform mode=arithmetic "
                f"option=typecast:float32,add:-127.5,div:127.5 ! tensor_filter "
                f'framework=xla-tpu model="{MODEL}" ! tensor_decoder '
                f"mode=image_labeling option1={labels} ! tensor_sink")
    out = subprocess.run([sys.executable, "-m", "nnstreamer_tpu_torch.cli",
                          "--device", "cpu", "-v", headline], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "[eos]" in out.stderr


# --------------------------------------------------------------------------- #
# the README's headline pipeline against the JAX package
# --------------------------------------------------------------------------- #

def _headline(labels: str) -> str:
    """The headline string at the small model, with the filter's input
    declared float32 (the transformed stream: the unfused JAX filter
    refuses a float32 stream against the model's uint8 input otherwise)
    and a tee after the filter to keep each frame's logits."""
    return (f"videotestsrc num-buffers=3 width={SIZE} height={SIZE} pattern=random ! "
            f"tensor_converter ! tensor_transform mode=arithmetic "
            f"option=typecast:float32,add:-127.5,div:127.5 ! "
            f"tensor_filter name=filt framework=xla-tpu model=zoo://x "
            f"input=3:{SIZE}:{SIZE}:1 inputtype=float32 ! tee name=t "
            f"t. ! queue ! tensor_decoder mode=image_labeling option1={labels} ! "
            f"tensor_sink name=labels store=true "
            f"t. ! queue ! tensor_sink name=logits store=true")


@pytest.fixture(scope="module")
def headline_models():
    jb = jax_get_model(MODEL)
    variables = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), jb.params)
    pb = make_mobilenet_v2(device=torch.device("cpu"), width="0.25", size=str(SIZE),
                           num_classes=str(CLASSES), dtype="float32")
    from_flax_variables(variables, pb.module)
    return dataclasses.replace(jb, metadata={}), pb


def _run_headline(parse, pipeline_cls, model, labels, auto_fuse, **pkw):
    p = parse(_headline(labels), pipeline_cls(**pkw))
    p.auto_fuse = auto_fuse
    p.get_by_name("filt").model = model
    p.run(timeout=300)
    labs = [b.meta["label_index"] for b in p.get_by_name("labels").buffers]
    logits = [np.asarray(b.memories[0].host()) for b in p.get_by_name("logits").buffers]
    return p, labs, logits


@pytest.mark.parametrize("auto_fuse", [True, False], ids=["fused", "unfused"])
def test_headline_pipeline_matches_jax(headline_models, tmp_path, auto_fuse):
    from nnstreamer_tpu.graph import Pipeline as JaxPipeline

    labels = tmp_path / "labels.txt"
    labels.write_text("\n".join(f"l{i}" for i in range(CLASSES)))
    jb, pb = headline_models
    jp, want_labels, want = _run_headline(jax_parse, JaxPipeline, jb, labels, auto_fuse)
    tp, got_labels, got = _run_headline(parse_pipeline, Pipeline, pb, labels, auto_fuse,
                                        device="cpu")
    assert jp._fused_count == tp._fused_count == int(auto_fuse)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.shape == w.shape == (1, CLASSES) and g.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4 * np.abs(w).max())
        top2 = np.sort(w[0])[-2:]
        assert top2[1] - top2[0] > 1e-5  # precondition of the exact labels
    assert got_labels == want_labels == [int(np.argmax(w)) for w in want]


def test_headline_fused_and_unfused_logits_are_bit_equal(headline_models, tmp_path):
    labels = tmp_path / "labels.txt"
    labels.write_text("\n".join(f"l{i}" for i in range(CLASSES)))
    _, pb = headline_models
    fp, fl, fused = _run_headline(parse_pipeline, Pipeline, pb, labels, True,
                                  device="cpu")
    up, ul, unfused = _run_headline(parse_pipeline, Pipeline, pb, labels, False,
                                    device="cpu")
    assert fp._fused_count == 1 and up._fused_count == 0
    assert fp.get_by_name("filt").fw is None  # closed at stop
    assert fl == ul
    for a, b in zip(fused, unfused):
        np.testing.assert_array_equal(a, b)


def test_unfused_headline_without_input_refuses_the_float_stream_like_jax(tmp_path):
    from nnstreamer_tpu.graph import Pipeline as JaxPipeline
    from nnstreamer_tpu.graph.pipeline import PipelineError as JaxError
    from nnstreamer_tpu_torch.graph import PipelineError

    s = (f"videotestsrc num-buffers=1 width={SIZE} height={SIZE} ! tensor_converter ! "
         "tensor_transform mode=arithmetic option=typecast:float32,div:255.0 ! "
         f'tensor_filter framework=xla-tpu model="{MODEL}" ! tensor_sink')
    for parse, cls, err, kw in ((jax_parse, JaxPipeline, JaxError, {}),
                                (parse_pipeline, Pipeline, PipelineError,
                                 {"device": "cpu"})):
        p = parse(s, cls(**kw))
        p.auto_fuse = False
        with pytest.raises(err, match="incompatible with model input"):
            p.run(timeout=120)


# --------------------------------------------------------------------------- #
# epilogue fusion of transform stages
# --------------------------------------------------------------------------- #

def _tail_run(auto_fuse, props, frames):
    from nnstreamer_tpu_torch.core import Caps, TensorsConfig, TensorsInfo

    p = Pipeline(device="cpu")
    p.auto_fuse = auto_fuse
    src = p.add_new("appsrc", caps=Caps.tensors(TensorsConfig(
        TensorsInfo.from_strings("6:1", "float32"))), data=list(frames))
    filt = p.add_new("tensor_filter", model=lambda t: t * 3 - 1)
    tr = p.add_new("tensor_transform", **props)
    sink = p.add_new("tensor_sink", store=True)
    Pipeline.link(src, filt, tr, sink)
    p.run(timeout=60)
    return p, tr, [b.memories[0].host() for b in sink.buffers]


@pytest.mark.parametrize("props", [
    {"mode": "arithmetic", "option": "mul:0.7,add:0.3,div:3"},
    {"transform_chain": [("typecast", "int16"), ("clamp", "-2:2")]},
    {"mode": "stand", "option": "default"},
], ids=["arithmetic", "chain", "stand"])
def test_epilogue_transform_stage_fuses_and_matches_unfused(props):
    frames = [np.random.default_rng(i).normal(size=(1, 6)).astype(np.float32)
              for i in range(3)]
    fp, ft, fused = _tail_run(True, props, frames)
    up, ut, unfused = _tail_run(False, props, frames)
    assert fp._epilogue_count == 1 and ft._fused_post
    assert up._epilogue_count == 0 and not ut._fused_post
    for a, b in zip(fused, unfused):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_filter_transform_decoder_tail_fuses_both_stages(tmp_path):
    # bench.py's epilogue composite: an identity typecast between the SSD
    # filter and its decoder; fused, both run inside the filter's invoke
    from nnstreamer_tpu_torch.models.ssd_mobilenet import write_box_priors

    priors = tmp_path / "priors.txt"
    write_box_priors(str(priors), size=64)

    def run(auto_fuse):
        p = Pipeline(device="cpu")
        p.auto_fuse = auto_fuse
        src = p.add_new("videotestsrc", width=64, height=64, pattern="random",
                        num_buffers=2)
        conv = p.add_new("tensor_converter")
        filt = p.add_new("tensor_filter", framework="xla-tpu",
                         model="zoo://ssd_mobilenet_v2?size=64&num_classes=4&width=0.35")
        tpost = p.add_new("tensor_transform", mode="typecast", option="float32")
        dec = p.add_new("tensor_decoder", mode="bounding_box", option1="mobilenet-ssd",
                        option3=str(priors), option4="64:64", option5="64:64",
                        async_depth=2)
        sink = p.add_new("tensor_sink", store=True)
        Pipeline.link(src, conv, filt, tpost, dec, sink)
        p.run(timeout=300)
        return p, [b.meta["detections"] for b in sink.buffers]

    fp, fused = run(True)
    up, unfused = run(False)
    assert fp._epilogue_count == 2 and up._epilogue_count == 0
    assert fused == unfused


# --------------------------------------------------------------------------- #
# SingleShot
# --------------------------------------------------------------------------- #

def test_singleshot_invokes_a_zoo_model(headline_models):
    _, pb = headline_models
    frame = np.random.default_rng(9).integers(0, 256, (1, SIZE, SIZE, 3), dtype=np.uint8)
    with SingleShot(model=pb, device="cpu") as single:
        assert str(single.input_info[0].dtype) == "uint8"
        out, = single.invoke(frame)
        with torch.inference_mode():
            want = pb.fn()(torch.from_numpy(frame))
        assert torch.equal(out, want)
        assert single.latency_us >= 0
    zoo = SingleShot(model=MODEL, device="cpu")
    assert zoo.framework == "torch-cuda"
    assert tuple(zoo.invoke(frame)[0].shape) == (1, CLASSES)
    zoo.close()


def test_singleshot_callable_matches_jax_singleshot():
    from nnstreamer_tpu.single import SingleShot as JaxSingleShot

    x = np.random.default_rng(10).normal(size=(2, 5)).astype(np.float32)
    want, = JaxSingleShot(model=lambda t: t * 2 + 1).invoke(x)
    got, = SingleShot(model=lambda t: t * 2 + 1, device="cpu").invoke(x)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_singleshot_update_model():
    from nnstreamer_tpu_torch.core import TensorsInfo

    info = TensorsInfo.from_strings("5:2", "float32")
    single = SingleShot(model=lambda t: t + 1, device="cpu", input_info=info)
    x = np.ones((2, 5), np.float32)
    assert torch.equal(single.invoke(x)[0], torch.full((2, 5), 2.0))
    single.update_model(lambda t: t * 10)
    assert torch.equal(single.invoke(x)[0], torch.full((2, 5), 10.0))
    with pytest.raises(ValueError, match="reload rejected"):
        single.update_model(lambda t: t[:, :2])
    assert torch.equal(single.invoke(x)[0], torch.full((2, 5), 10.0))
    single.close()


def test_singleshot_default_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SingleShot(model=lambda t: t)
