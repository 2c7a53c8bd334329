"""framework=torch (alias pytorch) on the port: TorchScript and the legacy
zip (filters/torch_backend.py, models/torch_legacy.py) against the JAX
package, on the CPU.

``tests/test_torch_backend.py`` holds the JAX filter: its two
``TestModernTorchScript`` cases run here on the port, names kept. Its
seven ``TestLegacyFormat`` cases need the reference's ``pytorch_lenet5.pt``,
which is not in the repository; here each runs on a legacy zip the test
writes by hand in the layout the loader reads (``chip_smoke.py``
``write_legacy_lenet``: ``model.json`` protoVersion 2, tensor blobs with an
offset and a strided view, the ``code/`` arena with the era's ops), through
the JAX package's loader and filter and the port's: outputs bit-equal on
the CPU, and the same errors. ``framework=auto`` resolves ``.pt`` to
``torch`` in both packages.
"""

import os
import re
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from nnstreamer_tpu.graph.parse import parse_pipeline as jparse  # noqa: E402
from nnstreamer_tpu.models.torch_legacy import (  # noqa: E402
    is_legacy_torchscript as jis_legacy, load_legacy_torchscript as jload_legacy)
from nnstreamer_tpu_torch.core.types import TensorsInfo  # noqa: E402
from nnstreamer_tpu_torch.graph import Pipeline  # noqa: E402
from nnstreamer_tpu_torch.graph.parse import parse_pipeline  # noqa: E402
from nnstreamer_tpu_torch.models.torch_legacy import (  # noqa: E402
    is_legacy_torchscript, load_legacy_torchscript)
from nnstreamer_tpu_torch.single import SingleShot  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import write_legacy_lenet  # noqa: E402

# the reference string (runTest.sh:72) apart from the paths
PIPELINE = (
    "filesrc location={img} ! pngdec ! videoscale ! imagefreeze ! "
    "videoconvert ! video/x-raw,format=GRAY8,framerate=0/1 ! "
    "tensor_converter ! "
    "tensor_filter framework=pytorch model={model} "
    "input=1:28:28:1 inputtype=uint8 output=10:1:1:1 outputtype=uint8 ! "
    "filesink location={out}"
)


def _scripted_lenet(path):
    """A freshly scripted small convnet in the modern TorchScript format."""

    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            torch.manual_seed(0)
            self.conv = torch.nn.Conv2d(1, 4, 3, 1)
            self.fc = torch.nn.Linear(4 * 26 * 26, 10)

        def forward(self, x):
            x = torch.relu(self.conv(x))
            return self.fc(x.reshape(x.size(0), -1))

    m = torch.jit.script(Net().eval())
    m.save(str(path))
    return m


@pytest.fixture
def legacy(tmp_path):
    path = str(tmp_path / "lenet_legacy.pt")
    net = write_legacy_lenet(path, seed=0)
    return path, net


@pytest.fixture
def digit(tmp_path):
    from PIL import Image

    img = np.random.default_rng(9).integers(0, 256, (28, 28), dtype=np.uint8)
    path = str(tmp_path / "9.png")
    Image.fromarray(img, "L").save(path)
    return path, img


class TestModernTorchScript:
    def test_scripted_module_served_golden(self, tmp_path):
        model_path = tmp_path / "net.pt"
        mod = _scripted_lenet(model_path)
        x = np.random.default_rng(7).standard_normal((1, 1, 28, 28)).astype(np.float32)
        with torch.no_grad():
            want = mod(torch.from_numpy(x)).numpy()
        s = SingleShot(framework="pytorch", model=str(model_path), device="cpu",
                       input_info=TensorsInfo.from_strings("28:28:1:1", "float32"),
                       output_info=TensorsInfo.from_strings("10:1", "float32"))
        got = np.asarray(s.invoke(x)[0])
        np.testing.assert_allclose(got.reshape(want.shape), want, rtol=1e-5, atol=1e-5)
        # framework=auto resolves .pt to the torch filter, in both packages
        from nnstreamer_tpu.filters.base import detect_framework as jdetect
        from nnstreamer_tpu_torch.filters.base import detect_framework

        assert detect_framework(str(model_path)) == jdetect(str(model_path)) == "torch"
        auto = SingleShot(model=str(model_path), device="cpu",
                          input_info=TensorsInfo.from_strings("28:28:1:1", "float32"))
        assert auto.framework == "torch"
        np.testing.assert_array_equal(np.asarray(auto.invoke(x)[0]), got)

    def test_not_torchscript_clear_error(self, tmp_path):
        bad = tmp_path / "weights.pt"
        torch.save({"w": torch.zeros(3)}, str(bad))  # state-dict, not TorchScript
        with pytest.raises(RuntimeError, match="TorchScript"):
            SingleShot(framework="pytorch", model=str(bad), device="cpu",
                       input_info=TensorsInfo.from_strings("3", "float32"),
                       output_info=TensorsInfo.from_strings("3", "float32"))


class TestLegacyFormat:
    def test_detects_legacy_zip(self, tmp_path, legacy, digit):
        path, _ = legacy
        modern = tmp_path / "m.pt"
        _scripted_lenet(modern)
        for detect in (jis_legacy, is_legacy_torchscript):
            assert detect(path)
            assert not detect(str(modern))
            assert not detect(digit[0])

    def test_modern_with_extra_model_json_not_misrouted(self, tmp_path):
        """_extra_files={'model.json': ...} must not trip legacy detection."""
        p = tmp_path / "extra.pt"

        class Id(torch.nn.Module):
            def forward(self, x):
                return x + 1

        torch.jit.save(torch.jit.script(Id()), str(p),
                       _extra_files={"model.json": "{}"})
        assert not jis_legacy(str(p)) and not is_legacy_torchscript(str(p))
        s = SingleShot(framework="torch", model=str(p), device="cpu",
                       input_info=TensorsInfo.from_strings("1", "float32"))
        assert int(np.asarray(s.invoke(np.zeros(1, np.float32))[0])[0]) == 1

    def test_legacy_loader_runs_lenet(self, legacy, digit):
        path, net = legacy
        x = torch.from_numpy(digit[1].reshape(1, 28, 28, 1))
        want = jload_legacy(path)(x)
        got = load_legacy_torchscript(path, "cpu")(x)
        assert tuple(got.shape) == (1, 10) and got.dtype == torch.uint8
        assert torch.equal(got, want)
        assert torch.equal(got, net(x))
        assert int(got.max()) < 255  # scores, not one saturated class

    def test_reference_pipeline_string_golden(self, tmp_path, legacy, digit):
        """runTest.sh:72 on the hand-built zip, through both packages."""
        text = [PIPELINE.format(img=digit[0], model=legacy[0],
                                out=tmp_path / f"tensorfilter{i}.out.log")
                for i in range(2)]
        jparse(text[0]).run(timeout=120)
        parse_pipeline(text[1], Pipeline(device="cpu")).run(timeout=120)
        outs = [np.frombuffer((tmp_path / f"tensorfilter{i}.out.log").read_bytes(),
                              np.uint8) for i in range(2)]
        assert outs[0].size == 10
        np.testing.assert_array_equal(outs[1], outs[0])
        assert int(outs[1].max()) < 255  # scores, not one saturated class

    def test_reference_negative_invalid_input(self, tmp_path, legacy, digit):
        """runTest.sh 2F_n: wrong input= dims must fail."""
        _both_fail(tmp_path, legacy, digit,
                   "input=1:28:28:1 inputtype=uint8 output=10:1:1:1 outputtype=uint8",
                   "input=7:1 inputtype=float32")

    def test_negative_same_size_dtype_mismatch(self, tmp_path, legacy, digit):
        """Declared int8 vs produced uint8 — same byte count, must still fail."""
        _both_fail(tmp_path, legacy, digit, "output=10:1:1:1 outputtype=uint8",
                   "output=10:1:1:1 outputtype=int8")

    def test_reference_negative_invalid_output(self, tmp_path, legacy, digit):
        """runTest.sh 3F_n: wrong output= dims must fail."""
        _both_fail(tmp_path, legacy, digit,
                   "input=1:28:28:1 inputtype=uint8 output=10:1:1:1 outputtype=uint8",
                   "output=1:7 outputtype=int8")


def _both_fail(tmp_path, legacy, digit, old, new):
    """The string with ``old`` replaced fails in both packages, with the
    same error type and the same filter message."""
    bad = PIPELINE.format(img=digit[0], model=legacy[0],
                          out=tmp_path / "o.log").replace(old, new)
    errors = []
    for run in (lambda: jparse(bad).run(timeout=60),
                lambda: parse_pipeline(bad, Pipeline(device="cpu")).run(timeout=60)):
        with pytest.raises(Exception) as e:
            run()
        errors.append(e.value)
    assert type(errors[0]).__name__ == type(errors[1]).__name__
    assert _root(errors[1]) == _root(errors[0])


def _root(err):
    """The innermost message of a pipeline error (the filter's own), with
    the element's generated name (a per-process count) left out."""
    msg = str(err)
    for marker in ("torch: ", "tensor_filter"):
        if marker in msg:
            line = msg[msg.index(marker):].split("\n")[0]
            return re.sub(r"^tensor_filter \S+: ", "tensor_filter: ", line)
    return type(err).__name__


def test_filter_output_checks_read_metadata_with_jax_texts(legacy):
    """The declared-output checks of an invoke: the JAX filter's texts,
    from the tensors' metadata (the outputs stay torch tensors)."""
    from nnstreamer_tpu.core.buffer import TensorMemory as JMem
    from nnstreamer_tpu.filters.base import FilterProps as JProps
    from nnstreamer_tpu.filters.torch_backend import TorchFilter as JTorch
    from nnstreamer_tpu_torch.core.buffer import TensorMemory
    from nnstreamer_tpu_torch.filters.base import FilterProps
    from nnstreamer_tpu_torch.filters.torch_backend import TorchFilter

    x = np.random.default_rng(2).integers(0, 256, (1, 28, 28, 1), dtype=np.uint8)
    declared = TensorsInfo.from_strings("10:1", "int8")
    from nnstreamer_tpu.core.types import TensorsInfo as JInfo

    jf, pf = JTorch(), TorchFilter()
    jf.open(JProps(model=legacy[0], output_info=JInfo.from_strings("10:1", "int8")))
    pf.open(FilterProps(model=legacy[0], output_info=declared, device="cpu"))
    with pytest.raises(RuntimeError) as je:
        jf.invoke([JMem(x)])
    with pytest.raises(RuntimeError) as pe:
        pf.invoke([TensorMemory(x)])
    assert str(pe.value) == str(je.value)
    ok = TorchFilter()
    ok.open(FilterProps(model=legacy[0], device="cpu"))
    out = ok.set_input_info(TensorsInfo.from_strings("1:28:28:1", "uint8"))
    assert out[0].shape == (1, 10) and str(out[0].dtype) == "uint8"
    got = ok.invoke([TensorMemory(x)])[0]
    assert got.is_device and got.device().dtype == torch.uint8
    np.testing.assert_array_equal(got.host(), legacy[1](torch.from_numpy(x)).numpy())
