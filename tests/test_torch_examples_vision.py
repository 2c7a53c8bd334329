"""The port's vision examples against the JAX package's, on the CPU.

Each JAX script (``examples/<name>.py``) runs in-process with ``sys.argv``
patched and its stdout captured; its ``_torch`` counterpart runs with
``device="cpu"`` at the same small size, handed the JAX zoo's variables
carried across with ``models/convert.py``. The JAX script's model spec is
pinned to float32 (its zoo memo holds the float32 bundle under the
script's own spec), so both packages classify the same seeded
``videotestsrc`` frames with float32 convolutions: the labels must be
equal frame for frame, and ``adaptive_batch_serving``'s PTS too. What the
JAX sink saw is recorded by wrapping its ``tensor_sink``'s ``chain``.
"""

import contextlib
import dataclasses
import io
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from nnstreamer_tpu.elements.sinks import TensorSink as JaxSink  # noqa: E402
from nnstreamer_tpu.models import zoo as jzoo  # noqa: E402
from nnstreamer_tpu_torch.models.convert import from_flax_variables  # noqa: E402
from nnstreamer_tpu_torch.models.mobilenet_v2 import make_mobilenet_v2  # noqa: E402

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "examples")
sys.path.insert(0, EXAMPLES)

import adaptive_batch_serving as j_abs  # noqa: E402
import adaptive_batch_serving_torch as t_abs  # noqa: E402
import classify_stream as j_cls  # noqa: E402
import classify_stream_torch as t_cls  # noqa: E402
import deploy_serve as j_dep  # noqa: E402
import deploy_serve_torch as t_dep  # noqa: E402

CPU = torch.device("cpu")


def run_jax(monkeypatch, main, argv):
    """Run a JAX example's ``main`` with ``argv``; returns its stdout and
    every buffer its tensor_sinks received, as (pts, label)."""
    seen = []
    chain = JaxSink.chain

    def recording(self, pad, buf):
        seen.append((buf.pts, buf.meta.get("label")))
        return chain(self, pad, buf)

    monkeypatch.setattr(JaxSink, "chain", recording)
    monkeypatch.setattr(sys, "argv", ["example"] + list(argv))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main()
    monkeypatch.setattr(JaxSink, "chain", chain)
    return out.getvalue(), seen


def run_port(fn, **kw):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = fn(**kw)
    return out.getvalue(), result


def float32_pair(monkeypatch, memo_opts, **opts):
    """The JAX zoo's float32 MobileNet-v2 for ``opts``, memoized under the
    spec options ``memo_opts`` the JAX script asks for, and the port's
    module bundle holding the same variables."""
    jb = jzoo.get_model("zoo://mobilenet_v2", dtype="float32", **opts)
    key = ("mobilenet_v2", tuple(sorted(memo_opts.items())))
    monkeypatch.setitem(jzoo._bundle_memo, key, jb)
    pb = make_mobilenet_v2(device=CPU, dtype="float32", **opts)
    from_flax_variables(jax.tree_util.tree_map(lambda a: np.array(a, np.float32),
                                               jb.params), pb.module)
    return jb, pb


def test_classify_stream_labels_equal_jax(monkeypatch):
    opts = {"width": "0.25", "size": "32"}
    _, pb = float32_pair(monkeypatch, opts, **opts)
    jout, jseen = run_jax(monkeypatch, j_cls.main,
                          ["--frames", "8", "--size", "32", "--width", "0.25",
                           "--cpu"])
    tout, labels = run_port(t_cls.classify, model=pb, frames=8, size=32,
                            width=0.25, device="cpu")
    want = [label for _, label in jseen]
    assert len(want) == 8 and labels == want
    # each frame line the port printed names that frame's JAX label
    lines = [ln for ln in tout.splitlines() if ln.startswith("frame ")]
    assert lines
    for ln in lines:
        idx, label = ln[len("frame "):].split(": ")
        assert want[int(idx)] == label
    # the tracer's rows (element names count every element made so far)
    for out in (jout, tout):
        assert "filter latency:" in out
        row = [ln for ln in out.splitlines() if ln.startswith("tensor_filter")]
        assert len(row) == 1 and row[0].split()[1] == "8"


def test_classify_stream_main_flags(monkeypatch):
    """``--cpu`` is ``--device cpu``; the default device is the card."""
    got = []
    monkeypatch.setattr(t_cls, "classify", lambda **kw: got.append(kw))
    assert t_cls.main(["--frames", "3", "--cpu"]) == 0
    assert t_cls.main(["--size", "64", "--device", "cpu"]) == 0
    assert t_cls.main([]) == 0
    assert [g["device"] for g in got] == ["cpu", "cpu", "cuda"]
    assert got[0]["frames"] == 3 and got[1]["size"] == 64
    assert got[2] == {"frames": 100, "size": 224, "width": 1.0, "device": "cuda"}


def test_adaptive_batch_serving_labels_and_pts_equal_jax(monkeypatch):
    _, pb = float32_pair(monkeypatch, {"size": "32", "batch": "4"},
                         size="32", batch="4")
    jout, jseen = run_jax(monkeypatch, j_abs.main,
                          ["--frames", "10", "--size", "32", "--batch", "4",
                           "--cpu"])
    tout, got = run_port(t_abs.serve, model=pb, frames=10, size=32, batch=4,
                         device="cpu")
    assert len(got) == 10 and got == jseen
    assert [pts for pts, _ in got] == sorted(pts for pts, _ in got)
    assert jout.startswith("10 per-frame results in ")
    assert tout.startswith("10 per-frame results in ")
    assert "batch=4, budget=50.0ms)" in jout and "batch=4, budget=50.0ms)" in tout


def test_deploy_serve_labels_equal_jax(monkeypatch):
    jb = jzoo.get_model(t_dep.SPEC)
    pb = make_mobilenet_v2(device=CPU, width="0.25", size="96",
                           num_classes="10", dtype="float32")
    from_flax_variables(jax.tree_util.tree_map(lambda a: np.array(a, np.float32),
                                               jb.params), pb.module)
    jout, jseen = run_jax(monkeypatch, j_dep.main, [])
    tout, labels = run_port(t_dep.deploy, bundle=dataclasses.replace(pb),
                            device="cpu")
    assert len(labels) == 8 and labels == [label for _, label in jseen]
    assert jout.splitlines()[-1] == tout.splitlines()[-1] == \
        f"served 8 frames; first label: {labels[0]}"
    assert ".jaxexport" in tout.splitlines()[0]
