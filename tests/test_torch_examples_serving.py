"""The port's serving, query and training examples against the JAX
package's, on the CPU.

Each JAX script runs in-process with its stdout captured; its ``_torch``
counterpart runs with ``device="cpu"``, handed the JAX script's weights
carried across with ``models/convert.py``:

* ``remote_offload``: the logits behind the query hop are byte-equal to the
  port's direct invoke of the same bundle, and within float32 tolerance
  (rtol 1e-4, atol 1e-4 of the scale) of the JAX script's;
* ``mqtt_fanout``: both subscribers get all 10 frames, in both packages;
* ``online_finetune``: from JAX's ``w0``, every step's loss within rtol
  1e-5 / atol 1e-6 of the JAX trainer's (tests/test_torch_trainer.py's);
* ``serve_lm``: greedy, sampled (temperature, nucleus, top-k), speculative
  and w8a8 tokens equal to JAX's, and the engine's counters equal;
* ``streaming_generate``: the tokens generated through the repo loop equal.
"""

import ast
import contextlib
import dataclasses
import io
import os
import re
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from nnstreamer_tpu.elements.sinks import TensorSink as JaxSink  # noqa: E402
from nnstreamer_tpu.elements.trainer import TensorTrainer as JaxTrainer  # noqa: E402
from nnstreamer_tpu.models import causal_lm as jlm  # noqa: E402
from nnstreamer_tpu.models import zoo as jzoo  # noqa: E402
from nnstreamer_tpu_torch.models.causal_lm import decode_apply  # noqa: E402
from nnstreamer_tpu_torch.models.convert import (causal_lm_params,  # noqa: E402
                                                 from_flax_variables)
from nnstreamer_tpu_torch.models.mobilenet_v2 import make_mobilenet_v2  # noqa: E402
from nnstreamer_tpu_torch.models.zoo import get_model  # noqa: E402
from nnstreamer_tpu_torch.single import SingleShot  # noqa: E402

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "examples")
sys.path.insert(0, EXAMPLES)

import mqtt_fanout as j_mqtt  # noqa: E402
import mqtt_fanout_torch as t_mqtt  # noqa: E402
import online_finetune as j_ft  # noqa: E402
import online_finetune_torch as t_ft  # noqa: E402
import remote_offload as j_ro  # noqa: E402
import remote_offload_torch as t_ro  # noqa: E402
import serve_lm as j_lm  # noqa: E402
import serve_lm_torch as t_lm  # noqa: E402
import streaming_generate as j_gen  # noqa: E402
import streaming_generate_torch as t_gen  # noqa: E402

CPU = torch.device("cpu")


def captured(fn, *args, **kw):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = fn(*args, **kw)
    return out.getvalue(), result


def run_jax(monkeypatch, main, argv=()):
    monkeypatch.setattr(sys, "argv", ["example"] + list(argv))
    return captured(main)[0]


def test_remote_offload_logits_equal_direct_invoke(monkeypatch):
    jb = jzoo.get_model(t_ro.SPEC)
    pb = make_mobilenet_v2(device=CPU, width="0.25", size="64",
                           num_classes="10", dtype="float32")
    from_flax_variables(jax.tree_util.tree_map(lambda a: np.array(a, np.float32),
                                               jb.params), pb.module)
    seen = []
    chain = JaxSink.chain

    def recording(self, pad, buf):
        seen.append(np.array(buf.memories[0].host()))
        return chain(self, pad, buf)

    monkeypatch.setattr(JaxSink, "chain", recording)
    jout = run_jax(monkeypatch, j_ro.main)
    monkeypatch.setattr(JaxSink, "chain", chain)
    tout, got = captured(t_ro.offload, model=pb, device="cpu")
    with SingleShot(model=pb, device="cpu") as single:
        direct = [single.invoke(f)[0].numpy() for f in t_ro.frames()]
    assert len(got) == len(direct) == len(seen) == 10
    for g, d, w in zip(got, direct, seen):
        assert g.dtype == d.dtype == np.float32 and g.shape == d.shape == (1, 10)
        assert g.tobytes() == d.tobytes()
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4 * np.abs(w).max())
    frame_lines = [ln for ln in tout.splitlines() if ln.startswith("frame ")]
    assert len(frame_lines) == 10
    assert len([ln for ln in jout.splitlines() if ln.startswith("frame ")]) == 10


def test_mqtt_fanout_every_subscriber_gets_every_frame(monkeypatch):
    jout = run_jax(monkeypatch, j_mqtt.main)
    tout, counts = captured(t_mqtt.fanout, device="cpu")
    assert counts == (10, 10)
    line = "recorder got 10, detector got 10"
    assert line in jout.splitlines() and line in tout.splitlines()
    assert "last transit latency" in tout


def test_online_finetune_losses_equal_jax(monkeypatch):
    trainers = []
    init = JaxTrainer.__init__

    def keep(self, *a, **kw):
        init(self, *a, **kw)
        trainers.append(self)

    monkeypatch.setattr(JaxTrainer, "__init__", keep)
    jout = run_jax(monkeypatch, j_ft.main)
    monkeypatch.setattr(JaxTrainer, "__init__", init)
    want = np.asarray(trainers[0].losses, np.float64)
    w0 = np.array(jax.random.normal(jax.random.PRNGKey(0), (16, 4)) * 0.1)
    tout, got = captured(t_ft.finetune, w0=torch.from_numpy(w0), device="cpu")
    assert len(got) == len(want) == 50
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert jout.splitlines()[0] == tout.splitlines()[0]  # rounded to 3 places
    assert tout.splitlines()[1] == jout.splitlines()[1] == \
        "trained params ready for filter.update_model(): (16, 4)"
    # the default weights come from the explicit generator, seeded 0
    assert torch.equal(t_ft.initial_weights(),
                       torch.randn((16, 4), generator=torch.Generator()
                                   .manual_seed(0)) * 0.1)


def _lm_lines(text):
    """``name -> [tokens]`` lines, the stats dict and the speculative line."""
    tokens, stats, spec = {}, None, None
    for ln in text.splitlines():
        m = re.match(r"^(.*?)\s*-> (\[.*\])$", ln)
        if m:
            tokens[m.group(1).strip()] = ast.literal_eval(m.group(2))
        elif ln.startswith("engine stats: "):
            stats = ast.literal_eval(ln[len("engine stats: "):])
            stats.pop("wall_s")
        elif ln.startswith("speculative: "):
            spec = ln
    return tokens, stats, spec


def test_serve_lm_tokens_equal_jax(monkeypatch):
    jout = run_jax(monkeypatch, j_lm.main, ["--cpu"])
    jp = jlm.init_causal_lm(jax.random.PRNGKey(0), t_lm.V, t_lm.D, t_lm.H,
                            t_lm.L, t_lm.MAXLEN)
    tp = causal_lm_params(jax.tree_util.tree_map(np.asarray, jp), CPU)
    tout, got = captured(t_lm.serve, params=tp, device="cpu")
    want_tokens, want_stats, want_spec = _lm_lines(jout)
    got_tokens, got_stats, got_spec = _lm_lines(tout)
    assert set(want_tokens) == {"greedy", "sampled t=1.0", "nucleus p=0.9",
                                "top-k 16", "w8a8 int8"}
    assert got_tokens == want_tokens
    for name in ("greedy", "sampled t=1.0", "nucleus p=0.9", "top-k 16"):
        assert got[name] == want_tokens[name] and len(got[name]) == 16
    assert got["w8a8"] == want_tokens["w8a8 int8"]
    assert got["speculative"] == got["plain"]
    assert got_stats == want_stats
    assert got_spec == want_spec


def test_streaming_generate_tokens_equal_jax(monkeypatch):
    jout = run_jax(monkeypatch, j_gen.main, ["--tokens", "8", "--cpu"])
    m = re.search(r"prompt=\[1, 7, 3\] generated=(\[.*\])", jout)
    want = ast.literal_eval(m.group(1))
    jb = jzoo.get_model(t_gen.SPEC)
    tp = causal_lm_params(jax.tree_util.tree_map(np.asarray, jb.params), CPU)
    pb = get_model(t_gen.SPEC, device=CPU)
    heads = pb.metadata["heads"]
    pb = dataclasses.replace(pb, apply=lambda *xs: decode_apply(tp, heads, *xs),
                             params=tp)
    tout, got = captured(t_gen.generate, bundle=pb, tokens=8, device="cpu")
    assert len(want) == 8 and got == want
    assert tout.strip() == f"prompt=[1, 7, 3] generated={want}"


def test_streaming_generate_flags():
    with pytest.raises(SystemExit):
        t_gen.main(["--prompt", "--device", "cpu"])
    with pytest.raises(SystemExit):
        t_gen.main(["--tokens", "70", "--device", "cpu"])
