"""The port's stream transformer (models/stream_transformer.py) against the
JAX package's.

JAX's ``TestStreamTransformer`` (tests/test_model_pipelines.py:124), all
three cases: the single-device forward, the sequence-parallel forward over
``sp`` 8 against the single-device one in the ``ring`` and ``a2a`` modes
— and here also ``ring-flash`` and ``a2a-flash``, the modes where B5
``flash_attention`` runs (on the CPU its plain version: the wrapper takes
the plain path for a CPU tensor) — and the aggregator → filter pipeline.
The port's bundles load the JAX bundle's flax variables
(``models.convert.load_flax``); inputs come from numpy seeds.

Tolerances: the forward rtol 1e-5 / atol 1e-5 against JAX at float32
(XLA's and the CPU BLAS's summation orders), the bf16 zoo default rtol /
atol 5e-2; sequence parallelism rtol 5e-3 / atol 5e-4, JAX's own for this
test, against JAX's single-device forward. The pipeline's windows equal
the port's own forward of the same window bit for bit, lie within rtol /
atol 1e-4 of the model evaluated in float64, and within 5e-2 of the JAX
pipeline's: its frames are constants (i) plus ``pos_embed``, so flax's
fast variance E[x²] − E[x]² cancels (≈ 49 against a variance of ≈ 4e-4),
and XLA's float32 LayerNorm lands 0.0038 and 0.0216 from the float64
forward on the two windows where the port's lands 3.9e-6 and 3.0e-5.
The sequence-parallel runs
are on 8 gloo ranks on the CPU; ``pos_embed`` is seeded, so a rank that
added rows 0..L/n instead of its own would be far outside tolerance.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import torch_ranks as tr  # noqa: E402
from nnstreamer_tpu.models.zoo import get_model as jget  # noqa: E402
from nnstreamer_tpu_torch.models.convert import load_flax  # noqa: E402
from nnstreamer_tpu_torch.models.zoo import get_model  # noqa: E402

SP_SPEC = "zoo://stream_transformer?layers=1&dim=32&heads=8&seq=64&dtype=float32"
SP_MODES = ("ring", "a2a", "ring-flash", "a2a-flash")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port(spec, jb):
    return load_flax(get_model(spec, device="cpu", fresh=True), _np(jb.params))


@pytest.fixture(scope="module")
def groups():
    g = tr.Groups()
    yield g
    g.close()


def _float64_forward(bundle, x):
    """The bundle's model evaluated in float64 (every module's compute
    dtype too): the function both packages round."""
    import copy

    m = copy.deepcopy(bundle.module).double()
    for mod in m.modules():
        if hasattr(mod, "dtype"):
            mod.dtype = torch.float64
    with torch.no_grad():
        return m(torch.from_numpy(x).double()).numpy()


class TestStreamTransformer:
    @pytest.mark.parametrize("spec", [
        "zoo://stream_transformer?layers=1&dim=32&heads=4&seq=16&dtype=float32",
        "zoo://stream_transformer?layers=2&dim=32&heads=4&seq=16&in_dim=8"
        "&dtype=float32"])
    def test_single_device_forward(self, spec):
        jb = jget(spec)
        d_in = jb.in_info[0].shape[-1]
        x = np.random.default_rng(0).normal(size=(1, 16, d_in)).astype(np.float32)
        want = np.asarray(jax.jit(jb.fn())(x))
        with torch.no_grad():
            got = _port(spec, jb).apply(torch.from_numpy(x)).numpy()
        assert got.shape == (1, 16, 32)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

    def test_sequence_parallel_matches_single_device(self, groups):
        jb = jget(SP_SPEC)
        x = np.random.default_rng(0).normal(size=(1, 64, 32)).astype(np.float32)
        ref = np.asarray(jb.fn()(x))
        for mode in SP_MODES:
            res = groups.run(8, tr.sp_apply, SP_SPEC, _np(jb.params),
                             {"sp": 8}, x, mode)
            for r in res:  # every rank returns the whole output
                np.testing.assert_allclose(r["y"], ref, rtol=5e-3, atol=5e-4,
                                           err_msg=mode)
                assert r["launches"] == 0  # the CPU runs B5's plain version

    def test_in_pipeline_with_aggregator(self):
        """Per-frame embeddings → aggregator window → transformer filter
        (the long-context streaming pattern), window for window equal to
        the JAX pipeline's."""
        spec = "zoo://stream_transformer?layers=1&dim=16&heads=2&seq=4&dtype=float32"
        frames = [np.full((1, 1, 16), i, np.float32) for i in range(8)]

        def run(pkg, model, **kw):
            core = __import__(f"{pkg}.core", fromlist=["Caps"])
            graph = __import__(f"{pkg}.graph", fromlist=["Pipeline"])
            p = graph.Pipeline(**kw)
            src = p.add_new("appsrc", caps=core.Caps.tensors(core.TensorsConfig(
                core.TensorsInfo.from_strings("16:1:1", "float32"), 30)),
                data=list(frames))
            agg = p.add_new("tensor_aggregator", frames_out=4, frames_dim=1)
            filt = p.add_new("tensor_filter", model=model)
            sink = p.add_new("tensor_sink", store=True)
            graph.Pipeline.link(src, agg, filt, sink)
            p.run(timeout=120)
            return [b.memories[0].host() for b in sink.buffers]

        jb = jget(spec)
        port = _port(spec, jb)
        want = run("nnstreamer_tpu", jb)
        got = run("nnstreamer_tpu_torch", port, device="cpu")
        assert len(got) == len(want) == 2
        for k, (g, w) in enumerate(zip(got, want)):
            assert g.shape == (1, 4, 16)
            window = np.concatenate(frames[4 * k:4 * k + 4], axis=1)
            with torch.no_grad():
                direct = port.apply(torch.from_numpy(window)).numpy()
            np.testing.assert_array_equal(g, direct)
            np.testing.assert_allclose(g, _float64_forward(port, window),
                                       rtol=1e-4, atol=1e-4)
            np.testing.assert_allclose(g, w, rtol=5e-2, atol=5e-2)


def test_zoo_default_bf16_forward():
    """The zoo default (bf16 compute, float32 parameters as flax keeps
    them) within bf16 tolerance of the JAX model."""
    spec = "zoo://stream_transformer?layers=1&dim=32&heads=4&seq=16"
    jb = jget(spec)
    x = np.random.default_rng(1).normal(size=(1, 16, 32)).astype(np.float32)
    want = np.asarray(jax.jit(jb.fn())(x))
    port = _port(spec, jb)
    assert all(p.dtype == torch.float32 for p in port.module.parameters())
    with torch.no_grad():
        got = port.apply(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=5e-2, atol=5e-2)


def test_zoo_registration_and_seeded_weights():
    from nnstreamer_tpu_torch.models.zoo import model_names

    assert "stream_transformer" in model_names()
    b = get_model("zoo://stream_transformer?layers=1&dim=32&heads=4&seq=16"
                  "&dtype=float32", device="cpu")
    assert b.in_info[0].shape == (1, 16, 32)
    pos = b.module.pos_embed.detach().numpy()
    assert np.abs(pos).max() > 0  # a fan-in normal, as JAX synthesizes it
    with torch.no_grad():
        out = b.apply(torch.zeros(1, 16, 32))
    assert out.shape == (1, 16, 32) and torch.isfinite(out).all()


def test_sp_apply_rejects_indivisible_sequence(groups):
    spec = "zoo://stream_transformer?layers=1&dim=32&heads=8&seq=60&dtype=float32"
    jb = jget(spec)
    x = np.zeros((1, 60, 32), np.float32)
    got = groups.run(8, tr.sp_apply, spec, _np(jb.params), {"sp": 8}, x, "ring")
    assert all("divisible" in g for g in got), got
