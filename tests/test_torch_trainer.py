"""The port's tensor_trainer against the JAX package's, on the CPU.

``nnstreamer_tpu_torch/elements/trainer.py`` steps a float32 master copy of
every leaf of the model's tree with optax's arithmetic (ops/optim.py), and
writes and resumes the JAX package's ``.msgpack`` checkpoints. The same
seeded frames go through both trainers:

  * tests/test_trainer.py's linear bundle (``x @ w``, w (8, 4)), 20 steps of
    sgd (momentum 0.9), adam and adamw (weight decay 1e-4): each loss and
    the final params within rtol 1e-5 / atol 1e-6 (float32; the two
    frameworks' matmuls and reductions round in their own orders, about
    1e-7 apart);
  * ``zoo://mobilenet_v2`` at width 0.35, size 32, 10 classes, float32,
    batch 2, 3 steps, with every leaf of the variables tree (params and
    batch_stats, which the JAX step differentiates too) compared in flax's
    layout: sgd within atol 1e-6 (measured 1.5e-8, none beyond 1e-5); adam
    within atol 5e-5 with at most 32 of the 423,018 elements beyond 1e-5
    (measured 2.26e-5 and 8: adam moves an element by about lr whatever
    its gradient's size, so rounding that parts the two runs' masters or
    gradients a little can part an element by a fraction of lr); the
    losses equal to 1e-6;
  * checkpoints: the port's files resume in the JAX trainer and the JAX
    trainer's in the port, bit for bit, each side's file byte-identical to
    the other's after a resume with no frames, and a JAX-written resume file
    continuing in the port with the JAX trainer's next losses.

The ``cuda`` case holds the card's steps against the CPU's.
"""

import functools
import shutil
import time
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import nnstreamer_tpu.core as jcore  # noqa: E402
import nnstreamer_tpu.graph as jgraph  # noqa: E402
from nnstreamer_tpu.models.zoo import ModelBundle as JaxBundle  # noqa: E402
from nnstreamer_tpu.models.zoo import get_model as jax_get_model  # noqa: E402
import nnstreamer_tpu_torch.core as tcore  # noqa: E402
import nnstreamer_tpu_torch.graph as tgraph  # noqa: E402
from nnstreamer_tpu_torch.models.convert import from_flax_variables  # noqa: E402
from nnstreamer_tpu_torch.models.mobilenet_v2 import make_mobilenet_v2  # noqa: E402
from nnstreamer_tpu_torch.models.zoo import get_model  # noqa: E402
from nnstreamer_tpu_torch.utils import checkpoints  # noqa: E402

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

TIMEOUT = 120
CPU = torch.device("cpu")
MNV2 = "zoo://mobilenet_v2?width=0.35&size=32&num_classes=10&dtype=float32"

JAX = SimpleNamespace(name="jax", core=jcore, graph=jgraph, kw={})
PORT = SimpleNamespace(name="torch", core=tcore, graph=tgraph, kw={"device": "cpu"})


def caps_of(ns, dims, types, rate=30):
    return ns.core.Caps.tensors(ns.core.TensorsConfig(
        ns.core.TensorsInfo.from_strings(dims, types), rate))


@functools.lru_cache(maxsize=None)
def _linear_w(seed=0):
    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (8, 4)) * 0.1)


def linear_model(ns, seed=0):
    """tests/test_trainer.py's linear_bundle in either package."""
    w = _linear_w(seed)
    if ns is JAX:
        return JaxBundle("linear", lambda p, x: x @ p, params=jax.numpy.asarray(w))
    return (lambda p, x: x @ p, w)


def linear_data(n=20, seed=0, batch=4):
    rng = np.random.default_rng(seed)
    true_w = rng.normal(size=(8, 4)).astype(np.float32)
    xs = rng.normal(size=(n, batch, 8)).astype(np.float32)
    ys = np.argmax(xs @ true_w, axis=-1).astype(np.int32)
    return [(x, y) for x, y in zip(xs, ys)]


def train(ns, model, data, dims="8:4,4", types="float32,int32", sink="fakesink",
          **props):
    p = ns.graph.Pipeline(**ns.kw)
    src = p.add_new("appsrc", caps=caps_of(ns, dims, types), data=data)
    tr = p.add_new("tensor_trainer", model=model, **props)
    s = p.add_new(sink, **({"store": True} if sink == "tensor_sink" else {}))
    ns.graph.Pipeline.link(src, tr, s)
    p.run(timeout=TIMEOUT)
    return tr, s, p


def _np_tree(tree):
    return jax.tree_util.tree_map(
        lambda t: t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t),
        tree)


# --------------------------------------------------------------------------- #
# parity with the JAX trainer
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("opt", ["sgd", "adam", "adamw"])
def test_linear_bundle_matches_jax(opt):
    got = {}
    for ns in (JAX, PORT):
        tr, _, _ = train(ns, linear_model(ns), linear_data(), learning_rate=0.05,
                         optimizer=opt)
        got[ns.name] = (np.array(tr.losses), _np_tree(tr.params))
    (jl, jp), (tl, tp) = got["jax"], got["torch"]
    assert len(tl) == 20 and tp.dtype == np.float32 and tp.shape == (8, 4)
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tp, jp, rtol=1e-5, atol=1e-6)
    assert np.mean(tl[-5:]) < np.mean(tl[:5])


@functools.lru_cache(maxsize=None)
def _jax_mnv2():
    return jax_get_model(MNV2)


def _port_mnv2():
    jb = _jax_mnv2()
    pb = make_mobilenet_v2(device=CPU, width="0.35", size="32", num_classes="10",
                           dtype="float32")
    from_flax_variables(_np_tree(jb.params), pb.module)
    return pb


def _mnv2_data(n=3, batch=2, seed=3):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 256, (batch, 32, 32, 3), dtype=np.uint8),
             rng.integers(0, 10, (batch,)).astype(np.int32)) for _ in range(n)]


@pytest.mark.parametrize("opt,atol,beyond", [("sgd", 1e-6, 0), ("adam", 5e-5, 32)])
def test_mobilenet_v2_every_leaf_matches_jax(opt, atol, beyond):
    """3 steps at batch 2 of the zoo's MobileNet-v2 (float32): every leaf of
    ``{"params", "batch_stats"}`` in flax's layout and key order."""
    models = {"jax": _jax_mnv2(), "torch": _port_mnv2()}
    got = {}
    for ns in (JAX, PORT):
        tr, _, _ = train(ns, models[ns.name], _mnv2_data(), dims="3:32:32:2,2",
                         types="uint8,int32", learning_rate=1e-3, optimizer=opt)
        got[ns.name] = (np.array(tr.losses), _np_tree(tr.params))
    (jl, jp), (tl, tp) = got["jax"], got["torch"]
    np.testing.assert_allclose(tl, jl, rtol=1e-6, atol=0)
    assert sorted(tp) == ["batch_stats", "params"]
    assert jax.tree_util.tree_structure(tp) == jax.tree_util.tree_structure(jp)
    diffs = [np.abs(a - b) for a, b in zip(jax.tree_util.tree_leaves(tp),
                                           jax.tree_util.tree_leaves(jp))]
    n = sum(d.size for d in diffs)
    far = sum(int((d > 1e-5).sum()) for d in diffs)
    worst = max(float(d.max()) for d in diffs)
    assert n == 423018
    assert worst <= atol and far <= beyond, (worst, far)


def test_to_flax_variables_inverts_from_flax_variables():
    """The carrier both ways: the JAX bundle's variables loaded into the
    port's module come back bit for bit, in the JAX tree's (sorted) key
    order, with ``batch_stats`` split out; a params tree with bf16 leaves
    carries onto a device unchanged."""
    from nnstreamer_tpu_torch.models.convert import tensor_tree, to_flax_variables

    want = _np_tree(_jax_mnv2().params)
    got = to_flax_variables(_port_mnv2().module, sort_keys=True)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    assert list(got) == list(want) == ["batch_stats", "params"]
    assert _leaves_bytes(got) == _leaves_bytes(want)
    tree = {"w": np.asarray(jax.numpy.linspace(-1, 1, 5, dtype=jax.numpy.bfloat16)),
            "b": [np.arange(3, dtype=np.int32), (np.float32(2.5),)]}
    t = tensor_tree(tree, CPU)
    assert t["w"].dtype == torch.bfloat16 and isinstance(t["b"][1], tuple)
    assert t["w"].view(torch.int16).numpy().tobytes() == tree["w"].tobytes()
    assert t["b"][0].tolist() == [0, 1, 2] and float(t["b"][1][0]) == 2.5


def test_batch_stats_are_trained_too():
    """The JAX step differentiates the whole variables tree: BatchNorm's
    running mean and variance move, in both packages alike."""
    pb = _port_mnv2()
    tr, _, _ = train(PORT, pb, _mnv2_data(1), dims="3:32:32:2,2", types="uint8,int32")
    before = _np_tree(_jax_mnv2().params)["batch_stats"]
    after = _np_tree(tr.params)["batch_stats"]
    moved = [not np.array_equal(a, b) for a, b in zip(jax.tree_util.tree_leaves(after),
                                                      jax.tree_util.tree_leaves(before))]
    assert all(moved)


# --------------------------------------------------------------------------- #
# tests/test_trainer.py's element cases, on the port
# --------------------------------------------------------------------------- #

def test_online_training_reduces_loss(tmp_path):
    ckpt = tmp_path / "trained.msgpack"
    tr, sink, p = train(PORT, linear_model(PORT), linear_data(), sink="tensor_sink",
                        learning_rate=0.05, checkpoint_path=str(ckpt), report_every=5)
    losses = list(tr.losses)
    assert len(losses) == 20 and np.mean(losses[-5:]) < np.mean(losses[:5])
    assert sink.buffers[0].meta["loss"] > 0
    assert ckpt.exists()
    reports = []
    while (m := p.bus.pop()) is not None:
        if m.data.get("trainer"):
            reports.append(m.data)
    assert [r["frames"] for r in reports if "loss" in r] == [5, 10, 15, 20]
    assert any(r.get("checkpoint") == str(ckpt) for r in reports)


def test_trained_params_deployable():
    tr, _, _ = train(PORT, linear_model(PORT), linear_data(10), learning_rate=0.05)
    bundle = tr.trained_bundle()
    out = bundle.fn()(torch.ones((1, 8)))
    assert tuple(out.shape) == (1, 4)
    torch.testing.assert_close(out, torch.ones((1, 8)) @ tr.params, rtol=0, atol=0)


def test_single_tensor_frame_rejected():
    with pytest.raises(tgraph.PipelineError, match="expects"):
        train(PORT, linear_model(PORT), [np.ones((1, 8), np.float32)], dims="8:1",
              types="float32")


def test_step_is_the_gradient_then_the_update_marking_its_parts():
    """``gradient`` leaves the masters alone and gives the loss and the
    masters' gradient autograd gives; ``step`` returns that loss, updates,
    and calls ``mark`` after each part in order."""
    from nnstreamer_tpu_torch.elements.trainer import TensorTrainer

    tr = TensorTrainer(model=linear_model(PORT), optimizer="sgd", learning_rate=0.1)
    tr.set_default_device("cpu")
    tr.start()
    x, y = (torch.from_numpy(a) for a in linear_data(1)[0])
    w = torch.tensor(_linear_w(), requires_grad=True)
    want = -torch.log_softmax(x @ w, -1)[torch.arange(4), y.long()].mean()
    loss, grad = tr.gradient(x, y)
    assert torch.equal(tr._masters.flat, w.detach().reshape(-1))
    assert torch.allclose(loss, want.detach(), rtol=1e-6, atol=0)
    assert torch.allclose(grad, torch.autograd.grad(want, w)[0].reshape(-1),
                          rtol=1e-6, atol=1e-7)
    marks = []
    assert torch.equal(tr.step(x, y, marks.append), loss)
    assert marks == ["cast", "forward", "backward", "optimizer"]
    assert not torch.equal(tr._masters.flat, w.detach().reshape(-1))


def test_bf16_model_keeps_float32_masters():
    """A bf16 model trains float32 masters (a bf16 weight cannot hold an
    lr 1e-3 update); the served bundle casts them back to bf16."""
    pb = make_mobilenet_v2(device=CPU, width="0.35", size="32", num_classes="10")
    tr, _, _ = train(PORT, pb, _mnv2_data(2), dims="3:32:32:2,2", types="uint8,int32")
    kernel = tr.params["params"]["Dense_0"]["kernel"]
    assert kernel.dtype == torch.float32
    assert not torch.equal(kernel, kernel.to(torch.bfloat16).float())
    served = tr.trained_bundle().module
    assert served.classifier.weight.dtype == torch.bfloat16
    assert torch.equal(served.classifier.weight, kernel.t().to(torch.bfloat16))


def _wait(pred, what, timeout=TIMEOUT):
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.01)


def test_hot_swap_serves_trained_weights_and_leaves_the_zoo_module_alone():
    """appsrc ! tee ! trainer, tee ! filter is-updatable: the zoo bundle the
    filter resolves is the one the trainer resolves, and stays untouched;
    swapped while the pipeline runs, the filter serves the trained
    bundle's outputs."""
    spec = "zoo://mobilenet_v2?width=0.35&size=32&num_classes=10&batch=2&seed=5"
    shared = get_model(spec, device=CPU).module
    before = {k: v.clone() for k, v in shared.state_dict().items()}
    data = _mnv2_data(5)
    p = tgraph.Pipeline(device="cpu")
    src = p.add_new("appsrc", caps=caps_of(PORT, "3:32:32:2,2", "uint8,int32"))
    tee = p.add_new("tee")
    tr = p.add_new("tensor_trainer", model=spec, learning_rate=1e-2)
    filt = p.add_new("tensor_filter", framework="xla-tpu", model=spec,
                     is_updatable=True, input_combination="0")
    sink = p.add_new("tensor_sink", store=True)
    tgraph.Pipeline.link(src, tee, p.add_new("queue"), tr, p.add_new("fakesink"))
    tgraph.Pipeline.link(tee, p.add_new("queue"), filt, sink)
    p.start()
    try:
        for frame in data[:4]:
            src.push_buffer(frame)
        _wait(lambda: tr._n == 4 and sink.num_buffers == 4, "4 frames")
        assert all(torch.equal(before[k], v) for k, v in shared.state_dict().items())
        trained = tr.trained_bundle()
        filt.update_model(trained)
        src.push_buffer(data[4])
        _wait(lambda: sink.num_buffers == 5, "the replayed frame")
        src.end_of_stream()
        assert p.wait_eos(TIMEOUT)
    finally:
        p.stop()
    assert all(torch.equal(before[k], v) for k, v in shared.state_dict().items())
    x = torch.from_numpy(data[4][0])
    with torch.inference_mode():
        initial = get_model(spec, device=CPU).fn()(x)
        want = trained.fn()(x)
    first = torch.from_numpy(data[0][0])
    with torch.inference_mode():
        assert torch.equal(sink.buffers[0].memories[0].device(),
                           get_model(spec, device=CPU).fn()(first))
    out = sink.buffers[4].memories[0].device()
    assert torch.equal(out, want) and not torch.equal(out, initial)


@pytest.mark.parametrize("mesh", ["data:4,model:2", {"data": 2}, "data", "data:x"])
def test_mesh_is_refused_naming_its_roadmap_item(mesh):
    """Outside ranks a mesh= is refused, naming what it needs (ranks started
    by parallel/launch.py); a malformed string names the form it wants.
    tests/test_torch_parallel.py trains with mesh= on ranks."""
    want = "mesh=.*parallel/launch.py" if mesh in ("data:4,model:2", {"data": 2}) \
        else "mesh= wants"
    with pytest.raises((tgraph.PipelineError, ValueError), match=want):
        train(PORT, linear_model(PORT), linear_data(1, batch=2), dims="8:2,2",
              mesh=mesh)


@pytest.mark.parametrize("mesh", ["", {}, None])
def test_empty_mesh_is_unsharded(mesh):
    tr, _, _ = train(PORT, linear_model(PORT), linear_data(2, batch=2), dims="8:2,2",
                     mesh=mesh)
    assert len(tr.losses) == 2


def test_orbax_checkpoint_path_is_refused(tmp_path):
    """checkpoint_path=<dir> (once refused, hence the name) writes an orbax
    directory on EOS and resumes from it: the second run starts at frame 2
    and the JAX package's load_variables reads the port's payload."""
    from nnstreamer_tpu.utils import checkpoints as jck

    ckpt = str(tmp_path / "orbax_ckpt")
    t1, _, _ = train(PORT, linear_model(PORT), linear_data(2, batch=2), dims="8:2,2",
                     checkpoint_path=ckpt, resume=True)
    t2, _, _ = train(PORT, linear_model(PORT), linear_data(1, batch=2), dims="8:2,2",
                     checkpoint_path=ckpt, resume=True)
    assert t2._n == 3
    saved = checkpoints.load_variables(ckpt)
    assert saved["frames"] == 3 and saved["opt_state"][1] is None
    import optax

    w = np.zeros((8, 4), np.float32)
    template = {"params": w, "frames": 0, "opt_state": optax.adam(1e-3).init(w)}
    back = jck.load_variables(ckpt, template)
    assert back["frames"] == 3
    assert np.asarray(back["params"]).tobytes() == _leaves_bytes(t2.params)[0]
    assert len(t1.losses) == 2


def test_plain_checkpoint_stays_servable(tmp_path):
    ckpt = tmp_path / "plain.msgpack"
    train(PORT, linear_model(PORT), linear_data(3, batch=2), dims="8:2,2",
          checkpoint_path=str(ckpt))
    w = checkpoints.load_variables(str(ckpt))
    assert w.shape == (8, 4) and w.dtype == np.float32


def test_resume_restores_params_opt_state_and_counter(tmp_path):
    ckpt = tmp_path / "resume.msgpack"
    rng = np.random.default_rng(0)
    true_w = rng.normal(size=(8, 4)).astype(np.float32)

    def run(n):
        data = []
        for _ in range(n):
            x = rng.normal(size=(4, 8)).astype(np.float32)
            data.append((x, np.argmax(x @ true_w, -1).astype(np.int32)))
        return train(PORT, linear_model(PORT), data, learning_rate=0.05,
                     optimizer="sgd", checkpoint_path=str(ckpt), resume=True)[0]

    t1 = run(15)
    t2 = run(15)
    assert t2._n == 30
    assert np.mean(list(t2.losses)[:5]) < np.mean(list(t1.losses)[:5])


@pytest.mark.parametrize("ns", [JAX, PORT], ids=["jax-file", "port-file"])
def test_resume_against_params_only_file_clear_error(tmp_path, ns):
    ckpt = str(tmp_path / "old.msgpack")
    if ns is JAX:
        from nnstreamer_tpu.utils import checkpoints as jck

        jck.save_variables(ckpt, jax.numpy.zeros((8, 4)))
    else:
        checkpoints.save_variables(ckpt, np.zeros((8, 4), np.float32))
    with pytest.raises((tgraph.PipelineError, ValueError), match="resume"):
        train(PORT, linear_model(PORT), linear_data(1, batch=2), dims="8:2,2",
              checkpoint_path=ckpt, resume=True)


# --------------------------------------------------------------------------- #
# checkpoints across the packages
# --------------------------------------------------------------------------- #

def _leaves_bytes(tree):
    return [np.asarray(a).tobytes() for a in jax.tree_util.tree_leaves(_np_tree(tree))]


@pytest.mark.parametrize("opt", ["sgd", "adam", "adamw"])
@pytest.mark.parametrize("writer", [JAX, PORT], ids=["jax-writes", "port-writes"])
def test_resume_files_cross_bit_for_bit(tmp_path, writer, opt):
    """One package trains 5 frames and writes a resume file; the other
    resumes it (masters bit-equal to the file, frame counter 5), and with no
    further frames writes back the same bytes."""
    reader = PORT if writer is JAX else JAX
    ckpt = tmp_path / "r.msgpack"
    tw, _, _ = train(writer, linear_model(writer), linear_data(5), learning_rate=0.05,
                     optimizer=opt, checkpoint_path=str(ckpt), resume=True)
    written = ckpt.read_bytes()
    tr, _, _ = train(reader, linear_model(reader), [], learning_rate=0.05,
                     optimizer=opt, checkpoint_path=str(ckpt), resume=True)
    assert tr._n == 5
    assert _leaves_bytes(tr.params) == _leaves_bytes(tw.params)
    assert ckpt.read_bytes() == written


@pytest.mark.parametrize("writer", [JAX, PORT], ids=["jax-writes", "port-writes"])
def test_mobilenet_resume_files_cross_bit_for_bit(tmp_path, writer):
    reader = PORT if writer is JAX else JAX
    ckpt = tmp_path / "m.msgpack"
    models = {"jax": _jax_mnv2(), "torch": _port_mnv2()}
    train(writer, models[writer.name], _mnv2_data(2), dims="3:32:32:2,2",
          types="uint8,int32", checkpoint_path=str(ckpt), resume=True)
    written = ckpt.read_bytes()
    tr, _, _ = train(reader, models[reader.name], [], dims="3:32:32:2,2",
                     types="uint8,int32", checkpoint_path=str(ckpt), resume=True)
    assert tr._n == 2 and ckpt.read_bytes() == written
    params = checkpoints.load_variables(str(ckpt))["params"]
    assert _leaves_bytes(tr.params) == _leaves_bytes(params)


def test_params_only_files_cross_bit_for_bit(tmp_path):
    """resume=false files: the JAX trainer's and the port's load in the other
    package's checkpoints module with the writer's masters."""
    from nnstreamer_tpu.utils import checkpoints as jck

    got = {}
    for ns in (JAX, PORT):
        path = str(tmp_path / f"{ns.name}.msgpack")
        tr, _, _ = train(ns, {"jax": _jax_mnv2(), "torch": _port_mnv2()}[ns.name],
                         _mnv2_data(1), dims="3:32:32:2,2", types="uint8,int32",
                         optimizer="sgd", checkpoint_path=path)
        got[ns.name] = (path, _leaves_bytes(tr.params))
    template = _np_tree(_jax_mnv2().params)
    assert _leaves_bytes(checkpoints.load_variables(got["jax"][0])) == got["jax"][1]
    assert _leaves_bytes(jck.load_variables(got["torch"][0], template)) == got["torch"][1]


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_jax_resume_file_continues_in_the_port(tmp_path, opt):
    """The JAX trainer trains 10 frames and writes a resume file; the JAX
    trainer and the port each resume a copy and train 10 more frames: the
    same losses (within the linear bound) and frame counter 20."""
    first = tmp_path / "first.msgpack"
    train(JAX, linear_model(JAX), linear_data(10), learning_rate=0.05, optimizer=opt,
          checkpoint_path=str(first), resume=True)
    more = linear_data(10, seed=1)
    losses = {}
    for ns in (JAX, PORT):
        path = tmp_path / f"{ns.name}.msgpack"
        shutil.copy(first, path)
        tr, _, _ = train(ns, linear_model(ns), more, learning_rate=0.05, optimizer=opt,
                         checkpoint_path=str(path), resume=True)
        assert tr._n == 20
        losses[ns.name] = np.array(tr.losses)
    np.testing.assert_allclose(losses["torch"], losses["jax"], rtol=1e-5, atol=1e-6)


# --------------------------------------------------------------------------- #
# on the card
# --------------------------------------------------------------------------- #

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_card_steps_match_the_cpu(cuda_device):
    """3 adam steps at batch 2, float32 with TF32 off: the card's losses
    within rtol 1e-5 of the CPU's, its masters within adam's bound."""
    got = {}
    for dev in ("cuda", "cpu"):
        p = tgraph.Pipeline(device=dev)
        src = p.add_new("appsrc", caps=caps_of(PORT, "3:32:32:2,2", "uint8,int32"),
                        data=_mnv2_data())
        tr = p.add_new("tensor_trainer", model=MNV2, learning_rate=1e-3)
        tgraph.Pipeline.link(src, tr, p.add_new("fakesink"))
        p.run(timeout=TIMEOUT)
        got[dev] = (np.array(tr.losses), _np_tree(tr.params))
    np.testing.assert_allclose(got["cuda"][0], got["cpu"][0], rtol=1e-5)
    worst = max(float(np.abs(a - b).max()) for a, b in zip(
        jax.tree_util.tree_leaves(got["cuda"][1]), jax.tree_util.tree_leaves(got["cpu"][1])))
    assert worst <= 2 * 3 * 1e-3
