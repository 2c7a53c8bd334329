"""The port's MoE streaming transformer (models/moe_transformer.py) against
the JAX package's: every case of tests/test_moe_model.py.

Zoo resolution and pipeline serving, expert-parallel inference on {data
2, expert 4}, the path-keyed placement rule, the router metrics (the JAX
model's sown ``moe_metrics``, returned here when asked), the seeded init's
non-zero experts, the batch and sequence divisibility errors, sequence ×
expert parallelism on {sp 2, expert 4} in ``ring`` and ``a2a`` (and here
``ring-flash`` and ``a2a-flash``, B5's plain version on the CPU), its
capacity factor, and ``ep_bundle`` served through the filter by the
leader/follower protocol. The port's bundles load the JAX bundle's flax
variables; inputs come from numpy seeds; the sharded runs are on 8 gloo
ranks on the CPU.

Tolerances: rtol 2e-4 / atol 2e-5 against the JAX single-device forward
(JAX's own); the router metrics' counts equal and the load-balance loss
within rtol 1e-5; at capacity factor 0.5, where tokens drop, sp×ep's
expert counts and dropped tokens equal the single-device run's (the
capacity positions follow the global (b, s) order).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_ranks as tr  # noqa: E402
from nnstreamer_tpu.models.zoo import get_model as jget  # noqa: E402
from nnstreamer_tpu_torch.models.convert import load_flax  # noqa: E402
from nnstreamer_tpu_torch.models.zoo import get_model  # noqa: E402

SPEC = ("zoo://moe_transformer?layers=2&dim=32&heads=4&experts=4&seq=16"
        "&dtype=float32")
TOL = dict(rtol=2e-4, atol=2e-5)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port(spec, jb):
    return load_flax(get_model(spec, device="cpu", fresh=True), _np(jb.params))


@pytest.fixture(scope="module")
def groups():
    g = tr.Groups()
    yield g
    g.close()


def test_zoo_resolution_and_shapes():
    jb = jget(SPEC)
    b = get_model(SPEC, device="cpu")
    assert b.in_info[0].shape == (1, 16, 32)
    assert b.out_info[0].shape == (1, 16, 32)
    x = np.random.default_rng(0).normal(size=(1, 16, 32)).astype(np.float32)
    with torch.no_grad():
        out = b.apply(torch.from_numpy(x))
        got = _port(SPEC, jb).apply(torch.from_numpy(x)).numpy()
    assert out.shape == (1, 16, 32) and torch.isfinite(out).all()
    np.testing.assert_allclose(got, np.asarray(jax.jit(jb.fn())(x)), **TOL)


def test_pipeline_serving():
    frames = [np.random.default_rng(i).normal(size=(1, 16, 32))
              .astype(np.float32) for i in range(4)]

    def run(pkg, model, **kw):
        core = __import__(f"{pkg}.core", fromlist=["Caps"])
        graph = __import__(f"{pkg}.graph", fromlist=["Pipeline"])
        p = graph.Pipeline(**kw)
        src = p.add_new("appsrc", caps=core.Caps.tensors(core.TensorsConfig(
            core.TensorsInfo.from_strings("32:16:1", "float32"))),
            data=list(frames))
        filt = p.add_new("tensor_filter", framework="xla-tpu", model=model)
        sink = p.add_new("tensor_sink", store=True)
        graph.Pipeline.link(src, filt, sink)
        p.run(timeout=120)
        return [b.memories[0].host() for b in sink.buffers]

    jb = jget(SPEC)
    want = run("nnstreamer_tpu", SPEC)
    got = run("nnstreamer_tpu_torch", _port(SPEC, jb), device="cpu")
    assert len(got) == 4 and got[0].shape == (1, 16, 32)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)
    # the zoo spec resolves on the port too
    assert len(run("nnstreamer_tpu_torch", SPEC, device="cpu")) == 4


def test_expert_parallel_equals_single_device(groups):
    jb = jget(SPEC + "&batch=2")
    x = np.random.default_rng(1).normal(size=(2, 16, 32)).astype(np.float32)
    want = np.asarray(jax.jit(jb.fn())(x))
    res = groups.run(8, tr.ep_infer, SPEC + "&batch=2", _np(jb.params),
                     {"data": 2, "expert": 4}, x)
    for r in res:
        np.testing.assert_allclose(r["y"], want, **TOL)
        # one of the four experts a rank
        assert r["local"] == {"blocks.moe_block_1.w1": (1, 32, 128),
                              "blocks.moe_block_1.w2": (1, 128, 32)}


def test_ep_param_shardings_rule(groups):
    got = groups.run(8, tr.ep_shardings, SPEC, {"data": 2, "expert": 4}, 4)[0]
    expert = [k for k, v in got.items() if v[1] == "Shard(dim=0)"]
    assert sorted(expert) == ["blocks.moe_block_1.w1", "blocks.moe_block_1.w2"]
    for name in expert:
        assert "moe_block" in name, name
    assert all(v == ["Replicate()", "Replicate()"]
               for k, v in got.items() if k not in expert)


def test_router_metrics_collection():
    from nnstreamer_tpu.models.moe_transformer import MoEStreamTransformer

    model = MoEStreamTransformer(layers=2, dim=32, heads=4, n_experts=4,
                                 dtype=jnp.float32)
    x = np.random.default_rng(0).normal(size=(1, 16, 32)).astype(np.float32)
    variables = model.init(jax.random.PRNGKey(0), jnp.asarray(x))
    _, aux = model.apply(variables, jnp.asarray(x), mutable=["moe_metrics"])
    jm = aux["moe_metrics"]["moe_block_1"]
    from_flax = load_flax(get_model(SPEC, device="cpu", fresh=True),
                          _np({"params": variables["params"]}))
    metrics = {}
    with torch.no_grad():
        from_flax.module(torch.from_numpy(x), metrics=metrics)
    assert list(metrics) == ["moe_block_1"]
    m = metrics["moe_block_1"]
    lb = float(m["load_balance_loss"])
    counts = m["expert_counts"].numpy()
    assert lb >= 1.0 - 1e-3
    assert counts.sum() == 16  # every token routed
    np.testing.assert_array_equal(counts, np.asarray(jm["expert_counts"][0]))
    np.testing.assert_allclose(lb, float(jm["load_balance_loss"][0]), rtol=1e-5)


def test_synthesized_init_has_nonzero_experts():
    """The zoo's seeded weights (synthesized as JAX synthesizes them on an
    accelerator) must not zero the router or the expert stacks: that would
    make every MoE layer a no-op."""
    b = get_model(SPEC, device="cpu", fresh=True)
    moe = b.module.blocks["moe_block_1"]
    for name in ("router", "w1", "w2"):
        assert getattr(moe, name).abs().max() > 0, f"{name} synthesized to zeros"
    with torch.no_grad():
        out = b.apply(torch.from_numpy(np.random.default_rng(0).normal(
            size=(1, 16, 32)).astype(np.float32)))
    assert torch.isfinite(out).all()


def test_ep_infer_rejects_indivisible_batch(groups):
    x = np.zeros((1, 16, 32), np.float32)
    got = groups.run(8, tr.ep_infer, SPEC, None, {"data": 2, "expert": 4}, x)
    assert all("divisible" in g for g in got), got
    # dp_axis=None serves any batch, replicated over data
    got = groups.run(8, tr.ep_infer, SPEC, None, {"data": 2, "expert": 4}, x,
                     None)
    assert all(r["y"].shape == (1, 16, 32) for r in got)


@pytest.mark.parametrize("sp_mode", ["ring", "a2a", "ring-flash", "a2a-flash"])
def test_sp_ep_composed_equals_single_device(groups, sp_mode):
    """Sequence-parallel attention × expert-parallel MoE on one 2-D mesh
    equals the single-device oracle."""
    jb = jget(SPEC)
    x = np.random.default_rng(2).normal(size=(1, 16, 32)).astype(np.float32)
    want = np.asarray(jax.jit(jb.fn())(x))
    res = groups.run(8, tr.sp_ep_infer, SPEC, _np(jb.params),
                     {"sp": 2, "expert": 4}, x, sp_mode)
    for r in res:
        np.testing.assert_allclose(r["y"], want, **TOL)


def test_sp_ep_rejects_indivisible_sequence(groups):
    spec = SPEC.replace("seq=16", "seq=15")
    got = groups.run(8, tr.sp_ep_infer, spec, None, {"sp": 2, "expert": 4},
                     np.zeros((1, 15, 32), np.float32), "ring")
    assert all("divisible" in g for g in got), got


def test_sp_ep_honors_nondefault_capacity_factor(groups):
    """The rebuilt sp×ep model keeps the bundle's capacity factor, and its
    capacity positions follow the global token order: at 0.5 the same
    tokens drop as on one device."""
    spec = SPEC + "&capacity_factor=0.5"
    jb = jget(spec)
    x = np.random.default_rng(5).normal(size=(1, 16, 32)).astype(np.float32)
    want = np.asarray(jax.jit(jb.fn())(x))
    res = groups.run(8, tr.sp_ep_infer, spec, _np(jb.params),
                     {"sp": 2, "expert": 4}, x, "ring", True)
    single = {}
    with torch.no_grad():
        _port(spec, jb).module(torch.from_numpy(x), metrics=single)
    assert float(single["moe_block_1"]["dropped"]) > 0
    for r in res:
        np.testing.assert_allclose(r["y"], want, **TOL)
        got = r["metrics"]["moe_block_1"]
        np.testing.assert_array_equal(got["expert_counts"],
                                      single["moe_block_1"]["expert_counts"].numpy())
        assert float(got["dropped"]) == float(single["moe_block_1"]["dropped"])


def test_ep_bundle_serves_through_filter(groups):
    """tensor_filter on the leader serves the expert-sharded MoE, equal to
    the unsharded oracle; the other ranks follow."""
    jb = jget(SPEC + "&batch=2")
    x = np.random.default_rng(3).normal(size=(2, 16, 32)).astype(np.float32)
    res = groups.run(8, tr.ep_serve, SPEC + "&batch=2", _np(jb.params),
                     {"data": 2, "expert": 4}, x)
    assert res[0]["name"] == "moe_transformer@ep4"
    np.testing.assert_allclose(res[0]["y"], np.asarray(jax.jit(jb.fn())(x)),
                               **TOL)
    assert all(r == {"invokes": 1} for r in res[1:])
