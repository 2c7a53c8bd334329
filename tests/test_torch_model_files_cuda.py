"""The port's model files on the card (marked ``cuda``; they skip without
one). This file imports no JAX: it runs on a machine with a card and no
flax.

* An exported program written on the CPU loads onto the card
  (``move_to_device_pass``: its constants and ``device=`` arguments) and
  the filter serves it through a CUDA graph, bit-equal to the zoo bundle
  on the card.
* A checkpoint restored on the card equals the same restore on the CPU
  moved up, leaf for leaf, from a ``.msgpack`` and from an orbax directory
  the port wrote; the committed orbax directory the JAX package wrote
  (tests/data/orbax_lenet_seed1) restores on the card bit-equal to its
  ``.msgpack`` twin.
* ``quant=w8`` computed on the card gives the CPU's codes and scales bit
  for bit.
* The legacy zip's tensors load onto the card and the torch filter's
  output stays there, equal to the eager module's.
"""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from nnstreamer_tpu_torch.core.buffer import TensorMemory  # noqa: E402
from nnstreamer_tpu_torch.filters.base import FilterProps  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda", 0)


def test_exported_program_serves_on_the_card_through_a_graph(tmp_path, card):
    from nnstreamer_tpu_torch.core import graphs
    from nnstreamer_tpu_torch.filters.torch_cuda import TorchCudaFilter
    from nnstreamer_tpu_torch.models import export_model, get_model

    spec = "zoo://mobilenet_v2?width=0.25&size=32&num_classes=7&dtype=float32"
    path = str(tmp_path / "m.jaxexport")
    export_model(path, get_model(spec, device="cpu"))
    f = TorchCudaFilter()
    f.open(FilterProps(model=path, device=card))
    zoo = get_model(spec, device=card)
    graphs.reset_stats()
    for seed in range(3):
        x = np.random.default_rng(seed).integers(0, 256, (1, 32, 32, 3), dtype=np.uint8)
        out = f.invoke([TensorMemory(x)])[0].device()
        assert out.device == card
        with torch.inference_mode():
            want = zoo.fn()(torch.from_numpy(x).to(card))
        assert torch.equal(out, want)
    st = graphs.stats()
    assert st["captures"] == 1 and st["replays"] >= 2
    f.close()


def test_checkpoint_restored_on_the_card_equals_the_cpu(tmp_path, card):
    from nnstreamer_tpu_torch.models import get_model, load_checkpointed
    from nnstreamer_tpu_torch.models.convert import to_flax_variables
    from nnstreamer_tpu_torch.utils.checkpoints import save_variables

    spec = "zoo://ssd_mobilenet_v2?width=0.35&size=64&num_classes=4&seed=1"
    ckpt = str(tmp_path / "ssd.msgpack")
    save_variables(ckpt, to_flax_variables(get_model(spec, device="cpu").module))
    opts = dict(width="0.35", size="64", num_classes="4")
    on_card = load_checkpointed(ckpt, "zoo://ssd_mobilenet_v2", device=card, **opts)
    on_cpu = load_checkpointed(ckpt, "zoo://ssd_mobilenet_v2", device="cpu", **opts)
    a, b = on_card.module.state_dict(), on_cpu.module.state_dict()
    for k in b:
        assert a[k].device == card and torch.equal(a[k].cpu(), b[k]), k


def test_orbax_dir_restored_on_the_card_equals_the_cpu(tmp_path, card):
    from nnstreamer_tpu_torch.models import get_model, load_checkpointed
    from nnstreamer_tpu_torch.models.convert import to_flax_variables
    from nnstreamer_tpu_torch.utils.checkpoints import save_variables

    spec = "zoo://ssd_mobilenet_v2?width=0.35&size=64&num_classes=4&seed=1"
    ckpt = str(tmp_path / "ssd")
    save_variables(ckpt, to_flax_variables(get_model(spec, device="cpu").module))
    opts = dict(width="0.35", size="64", num_classes="4")
    on_card = load_checkpointed(ckpt, "zoo://ssd_mobilenet_v2", device=card, **opts)
    on_cpu = load_checkpointed(ckpt, "zoo://ssd_mobilenet_v2", device="cpu", **opts)
    a, b = on_card.module.state_dict(), on_cpu.module.state_dict()
    for k in b:
        assert a[k].device == card and torch.equal(a[k].cpu(), b[k]), k


def test_jax_written_orbax_fixture_restores_on_the_card(card):
    from nnstreamer_tpu_torch.models import load_checkpointed

    data = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
    restored = {name: load_checkpointed(os.path.join(data, name), "zoo://lenet",
                                        device=card)
                for name in ("orbax_lenet_seed1", "lenet_seed1.msgpack")}
    a, b = (r.module.state_dict() for r in restored.values())
    for k in b:
        assert a[k].device == card and torch.equal(a[k], b[k]), k
    x = torch.from_numpy(np.random.default_rng(8).integers(
        0, 256, (1, 28, 28, 1), dtype=np.uint8)).to(card)
    with torch.inference_mode():
        outs = [r.fn()(x) for r in restored.values()]
    assert torch.equal(outs[0], outs[1])


def test_quant_w8_codes_on_the_card_equal_the_cpu(card):
    from nnstreamer_tpu_torch.models import get_model
    from nnstreamer_tpu_torch.models.quantize import quantize_bundle

    spec = "zoo://mobilenet_v1?width=0.5&size=64&num_classes=16"
    got = quantize_bundle(get_model(spec, device=card, fresh=True)).params
    want = quantize_bundle(get_model(spec, device="cpu", fresh=True)).params

    def walk(g, w, path=""):
        if isinstance(w, dict):
            for k in w:
                walk(g[k], w[k], f"{path}/{k}")
        else:
            assert g.device == card and g.dtype == w.dtype, path
            assert torch.equal(g.cpu(), w), path

    walk(got, want)


def test_legacy_zip_runs_on_the_card(tmp_path, card):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from chip_smoke import write_legacy_lenet
    from nnstreamer_tpu_torch.filters.torch_backend import TorchFilter
    from nnstreamer_tpu_torch.models.torch_legacy import load_legacy_torchscript

    path = str(tmp_path / "legacy.pt")
    net = write_legacy_lenet(path, seed=0).to(card)
    x = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, (1, 28, 28, 1), dtype=np.uint8))
    mod = load_legacy_torchscript(path, card)
    assert mod.conv1.weight.device == card and mod.fc.weight.device == card
    f = TorchFilter()
    f.open(FilterProps(model=path, device=card))
    out = f.invoke([TensorMemory(x)])[0].device()
    assert out.device == card
    with torch.no_grad():
        assert torch.equal(out, net(x.to(card)))
