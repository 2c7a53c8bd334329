"""The port's parallel layer (nnstreamer_tpu_torch/parallel/) against the JAX
package's, on gloo ranks on the CPU.

Every case of tests/test_parallel.py, at its world sizes (8 ranks
for the 8-device virtual mesh; 4 and 2 where it builds smaller meshes), and
the five mesh cases of test_causal_lm.py. The JAX side runs in this process
on the 8-device virtual CPU mesh; the port on ranks started by
parallel/launch.py (one group per world size for the module), the inputs
made from a seed with numpy. Where JAX takes the global arrays, each rank
here takes the whole input and cuts its own shard (ring and a2a attention
return the rank's output shard, joined here in rank order).

Tolerances, each the JAX test's own: ring, ring-flash and a2a attention rtol
2e-4 / atol 2e-5 against the dense oracle and against the JAX functions;
GPipe rtol 2e-5 / atol 2e-6; expert parallelism rtol 2e-4 / atol 2e-5
(token counts equal); sharded inference rtol 1e-5; checkpoint resume rtol
1e-5 / atol 1e-6 on the same mesh and 1e-4 / 1e-5 onto a re-shaped one; the
sequence-parallel prefill's logits rtol 2e-4 / atol 2e-5 against
``lm_forward``. Shardings compare as placements: ``P(None, "model")`` is
``Shard(1)`` on the model axis.

The six cases that serve a sharded model through ``tensor_filter`` and the
query server (``test_query_offload_to_mesh_sharded_server``,
``test_sharded_bundle_honors_fused_preprocess_and_bf16``,
``test_composite_sharded_pipeline_with_query_offload``,
``test_sharded_uneven_final_batch``, ``test_sharded_reload_reshards`` and
``test_composite_query_failover_retry``) are in
tests/test_torch_sharded_serving.py.

Port-only: device and backend choice, a rank's exception and a collective
timeout surfacing in the parent, each collective helper, the a2a causal
mode, the trainer's ``mesh=`` and the checkpoint format (a
``torch.distributed.checkpoint`` directory written; the JAX package's orbax
directories read too).
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_ranks as tr  # noqa: E402
from nnstreamer_tpu.parallel import make_mesh as jmake_mesh  # noqa: E402
from nnstreamer_tpu_torch.parallel import launch  # noqa: E402


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def groups():
    g = tr.Groups()
    yield g
    g.close()


# -- launcher, mesh and collectives (port-only) ------------------------------ #

def test_device_count(groups):
    """8 ranks, each on the CPU with one thread, gloo (the counterpart of
    the 8 virtual devices)."""
    got = groups.run(8, tr.rank_info)
    assert [g["rank"] for g in got] == list(range(8))
    assert all(g["world"] == 8 and g["backend"] == "gloo"
               and g["device"] == "cpu" and g["threads"] == 1 for g in got)


def test_plan_chooses_device_and_backend(monkeypatch):
    assert launch.plan(3, "cpu") == (["cpu"] * 3, "gloo")
    with pytest.raises(ValueError, match="gloo"):
        launch.plan(2, "cpu", backend="nccl")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch.plan(2)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert launch.plan(2) == (["cuda:0", "cuda:1"], "nccl")   # a card each
    assert launch.plan(4) == (["cuda:0", "cuda:1", "cuda:0", "cuda:1"],
                              "gloo")                          # shared cards
    assert launch.plan(1, backend="gloo") == (["cuda:0"], "gloo")
    with pytest.raises(ValueError, match="one rank a card"):
        launch.plan(4, backend="nccl")


def test_rank_device_outside_the_launcher(monkeypatch):
    """Outside ranks parallel/launch.py started (a process group of the
    caller's own), the port's device rule: the current card, and without
    one a refusal, never a quiet CPU."""
    monkeypatch.setattr(launch, "_RANK_DEVICE", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch.rank_device()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    assert launch.rank_device() == torch.device("cuda", 1)
    monkeypatch.setattr(launch, "_RANK_DEVICE", torch.device("cpu"))
    assert launch.rank_device() == torch.device("cpu")  # the launcher's


def test_rank_exception_surfaces_in_the_parent():
    with launch.RankGroup(2, device="cpu", timeout=20) as g:
        with pytest.raises(launch.RankError, match="deliberate failure") as e:
            g.run(tr.raise_on, 1)
        assert e.value.rank == 1
        assert g.closed  # a failed group is not reused
        with pytest.raises(RuntimeError, match="closed"):
            g.run(tr.rank_info)


def test_collective_timeout_surfaces_in_the_parent():
    """Rank 0 enters an all_reduce rank 1 never joins: rank 0's collective
    fails within the group's timeout and the parent raises naming it."""
    with launch.RankGroup(2, device="cpu", timeout=3) as g:
        with pytest.raises(launch.RankError) as e:
            g.run(tr.hang_collective, 0, wait=60)
        assert e.value.rank == 0


def test_make_mesh_validates(groups):
    err = groups.run(8, tr.make_mesh_error, {"data": 3})
    assert all("devices" in e for e in err), err
    with pytest.raises(ValueError, match="devices"):
        jmake_mesh({"data": 3})


def test_auto_mesh_2d(groups):
    assert groups.run(8, tr.auto_mesh, 8, None)[0] == {"data": 4, "model": 2}
    assert groups.run(8, tr.auto_mesh, 8, 4)[0] == {"data": 2, "model": 4}


@pytest.mark.parametrize("axes,axis", [({"x": 4}, "x"),
                                       ({"data": 2, "model": 2}, "model"),
                                       ({"data": 2, "model": 2}, "data")])
def test_collective_helpers(groups, axes, axis):
    got = groups.run(4, tr.collectives, axes, axis)
    names = list(axes)
    dims = [axes[a] for a in names]
    for rank, res in enumerate(got):
        coord = dict(zip(names, np.unravel_index(rank, dims)))
        peers = []  # the ranks of this rank's axis group, by coordinate
        for j in range(axes[axis]):
            c = dict(coord, **{axis: j})
            peers.append(int(np.ravel_multi_index([c[a] for a in names], dims)))
        n = len(peers)
        me = coord[axis]
        assert res["index"] == me and res["size"] == n
        assert res["shape"] == axes
        xs = [got[p]["x"] for p in peers]
        np.testing.assert_allclose(res["psum"], sum(xs), rtol=1e-6)
        np.testing.assert_array_equal(res["psum_i"],
                                      sum(got[p]["xi"] for p in peers))
        np.testing.assert_array_equal(res["pmax"], np.maximum.reduce(xs))
        # rotation (j → j-1): this rank holds coordinate me+1's x
        np.testing.assert_array_equal(res["ppermute"], xs[(me + 1) % n])
        want = np.concatenate([np.split(got[p]["a2a_in"], n)[me]
                               for p in peers], axis=1)
        np.testing.assert_array_equal(res["all_to_all"], want)
        np.testing.assert_array_equal(res["all_gather"], np.concatenate(xs))
        np.testing.assert_array_equal(res["broadcast"], xs[1 % n])


# -- sharding, sharded steps ------------------------------------------------- #

def test_shard_params_layout(groups):
    params = {"dense": {"kernel": np.ones((16, 8), np.float32),
                        "bias": np.ones((8,), np.float32)},
              "odd": {"kernel": np.ones((5, 3), np.float32)}}
    got = groups.run(8, tr.shard_layout, params, {"data": 4, "model": 2})
    for res in got:
        pl = res["placements"]
        assert pl["dense/kernel"] == ["Replicate()", "Shard(dim=1)"]
        assert pl["dense/bias"] == ["Replicate()", "Shard(dim=0)"]
        assert pl["odd/kernel"] == ["Replicate()", "Replicate()"]
        assert res["local"]["dense/kernel"] == (16, 4)
        assert res["local"]["odd/kernel"] == (5, 3)


def test_sharded_infer_step(groups):
    from nnstreamer_tpu.parallel import (auto_mesh_2d, batch_sharding,
                                         make_sharded_infer_step)

    w = np.random.default_rng(0).normal(size=(16, 8)).astype(np.float32)
    x = np.random.default_rng(1).normal(size=(8, 16)).astype(np.float32)
    mesh = auto_mesh_2d(8, model_parallel=2)
    fn, p = make_sharded_infer_step(lambda p, x: x @ p, w, mesh)
    jout = np.asarray(fn(p, jax.device_put(x, batch_sharding(mesh))))
    got = groups.run(8, tr.sharded_infer, w, x, {"data": 4, "model": 2})
    for out in got:
        np.testing.assert_allclose(out, x @ w, rtol=1e-5)
        np.testing.assert_allclose(out, jout, rtol=1e-5)


def test_sharded_train_step_converges(groups):
    from nnstreamer_tpu.parallel import auto_mesh_2d, make_sharded_train_step

    rng = np.random.default_rng(0)
    w = rng.normal(size=(8, 4)).astype(np.float32) * 0.1
    x = rng.normal(size=(16, 8)).astype(np.float32)
    y = rng.integers(0, 4, (16,)).astype(np.int32)
    step, params, opt = make_sharded_train_step(
        lambda p, x: x @ p, w, auto_mesh_2d(8, model_parallel=2))
    jl = []
    for _ in range(5):
        params, opt, loss = step(params, opt, x, y)
        jl.append(float(loss))
    got = groups.run(8, tr.sharded_train, w, x, y, {"data": 4, "model": 2}, 5)
    for res in got:
        assert res["losses"][-1] < res["losses"][0]
        np.testing.assert_allclose(res["losses"], jl, rtol=1e-5)
        np.testing.assert_allclose(res["params"], np.asarray(params),
                                   rtol=1e-5, atol=1e-6)
        assert res["placements"] == ["Replicate()", "Shard(dim=1)"]


class TestShardedCheckpoint:
    """Save, restore (same or re-shaped mesh) and resume == straight
    through (parallel/checkpoint.py)."""

    @staticmethod
    def _setup(seed=0):
        rng = np.random.default_rng(seed)
        w = {"w1": rng.normal(size=(8, 16)).astype(np.float32) * 0.1,
             "w2": rng.normal(size=(16, 4)).astype(np.float32) * 0.1}
        x = rng.normal(size=(16, 8)).astype(np.float32)
        y = rng.integers(0, 4, (16,)).astype(np.int32)
        return w, x, y

    def test_resume_equals_straight_through(self, groups, tmp_path):
        w, x, y = self._setup()
        axes = {"data": 4, "model": 2}
        got = groups.run(8, tr.ckpt_resume, w, x, y, axes,
                         str(tmp_path / "ckpt"), axes)
        for res in got:
            assert res["placements"] == res["want_placements"]
            assert np.isclose(res["loss_res"], res["loss_ref"], rtol=1e-5)
            for k in ("w1", "w2"):
                np.testing.assert_allclose(res["p_res"][k], res["p_ref"][k],
                                           rtol=1e-5, atol=1e-6)

    def test_restore_onto_reshaped_mesh(self, groups, tmp_path):
        w, x, y = self._setup()
        got = groups.run(8, tr.ckpt_resume, w, x, y, {"data": 4, "model": 2},
                         str(tmp_path / "ckpt"), {"data": 2, "model": 4})
        for res in got:
            assert res["placements"] == res["want_placements"]
            assert res["placements"]["w1"] == ["Replicate()", "Shard(dim=1)"]
            assert all(m == (2, 4) for m in res["meshes"].values())
            assert np.isclose(res["loss_res"], res["loss_ref"], rtol=1e-4)
            for k in ("w1", "w2"):
                np.testing.assert_allclose(res["p_res"][k], res["p_ref"][k],
                                           rtol=1e-4, atol=1e-5)

    def test_params_only_and_host_restore(self, groups, tmp_path):
        w, _, _ = self._setup()
        got = groups.run(8, tr.ckpt_partial, w, {"data": 4, "model": 2},
                         str(tmp_path))
        for res in got:
            assert res["host_opt"] is None
            assert res["host_is_numpy"]
            for k in ("w1", "w2"):
                np.testing.assert_array_equal(res["host"][k], res["params"][k])

    def test_partial_restores_both_directions(self, groups, tmp_path):
        w, _, _ = self._setup()
        got = groups.run(8, tr.ckpt_partial, w, {"data": 4, "model": 2},
                         str(tmp_path))
        for res in got:
            assert res["full_opt"] is None     # stored opt state discarded
            assert res["ponly_opt"] is None    # none stored: None back
            for k in ("w1", "w2"):
                np.testing.assert_array_equal(res["full_params_only"][k],
                                              res["params"][k])
                np.testing.assert_array_equal(res["ponly_params"][k],
                                              res["params"][k])

    def test_checkpoint_format_is_torch_distributed_not_orbax(self, groups,
                                                              tmp_path):
        """A chosen divergence of the save side: the port writes
        torch.distributed.checkpoint directories; .msgpack paths are refused
        as in JAX. The restore side also reads the orbax directory the JAX
        package's save_sharded_state writes (here from arrays sharded over
        its 8-device mesh, with optax's sgd state): every rank gets the
        logical params and momentum traces bit-equal, in the placements of
        its own train state."""
        import optax
        from jax.sharding import NamedSharding
        from jax.sharding import PartitionSpec as P

        from nnstreamer_tpu.parallel import save_sharded_state as jsave

        w, _, _ = self._setup()
        axes = {"data": 4, "model": 2}
        got = groups.run(8, tr.ckpt_partial, w, axes, str(tmp_path))
        assert os.path.isfile(tmp_path / "full" / ".metadata")
        assert all(r["msgpack"] and ".msgpack" in r["msgpack"] for r in got)
        jmesh = jmake_mesh(axes)
        jw = {"w1": jax.device_put(jnp.asarray(w["w1"]),
                                   NamedSharding(jmesh, P(None, "model"))),
              "w2": jnp.asarray(w["w2"])}
        opt = optax.sgd(1e-3, momentum=0.9)
        grads = {k: jnp.asarray(np.random.default_rng(9).normal(size=v.shape),
                                jnp.float32) for k, v in w.items()}
        _, state = opt.update(grads, opt.init(jw), jw)
        jsave(str(tmp_path / "orbax"), jw, state)
        got = groups.run(8, tr.ckpt_from_orbax, w, axes, str(tmp_path / "orbax"))
        for res in got:
            assert res["placements"] == res["want_placements"]
            assert res["trace_placements"] == res["want_trace_placements"]
            for k in ("w1", "w2"):
                assert np.asarray(res["params"][k]).tobytes() == w[k].tobytes()
                assert np.asarray(res["trace"][k]).tobytes() == \
                    np.asarray(state[0].trace[k]).tobytes()


# -- sequence parallelism ---------------------------------------------------- #

def _qkv(b=2, h=4, length=64, d=16, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, h, length, d)).astype(np.float32) * 0.3
            for _ in range(3)]


def _joined(got):
    return np.concatenate(got, axis=2)


class TestSequenceParallel:
    @pytest.mark.parametrize("causal", [False, True])
    def test_ring_attention(self, groups, causal):
        from nnstreamer_tpu.parallel.ring import (reference_attention,
                                                  ring_attention)

        q, k, v = _qkv(seed=1 if causal else 0)
        mesh = jmake_mesh({"sp": 8})
        jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
        ref = np.asarray(reference_attention(jq, jk, jv, causal=causal))
        jring = np.asarray(ring_attention(jq, jk, jv, mesh, "sp",
                                          causal=causal))
        out = _joined(groups.run(8, tr.sp_attention, q, k, v, {"sp": 8},
                                 "ring", causal))
        np.testing.assert_allclose(out, ref, rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(out, jring, rtol=2e-4, atol=2e-5)

    def test_a2a_attention_exact(self, groups):
        from nnstreamer_tpu.parallel.ring import (a2a_attention,
                                                  reference_attention)

        q, k, v = _qkv(h=8, seed=2)
        jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
        ref = np.asarray(reference_attention(jq, jk, jv))
        ja2a = np.asarray(a2a_attention(jq, jk, jv, jmake_mesh({"sp": 8}),
                                        "sp"))
        out = _joined(groups.run(8, tr.sp_attention, q, k, v, {"sp": 8},
                                 "a2a", False))
        np.testing.assert_allclose(out, ref, rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(out, ja2a, rtol=2e-4, atol=2e-5)

    def test_a2a_rejects_bad_heads(self, groups):
        q, _, _ = _qkv(h=4)
        err = groups.run(8, tr.sp_error, q[:, :, :8], {"sp": 8}, "a2a")
        assert all(e and "divisible" in e for e in err), err

    @pytest.mark.parametrize("causal", [False, True])
    def test_ring_flash_attention_exact(self, groups, causal):
        """Each shard pair through the flash kernel's residual mode (its
        plain version on the CPU), merged through (m, l)."""
        from nnstreamer_tpu.parallel.ring import (reference_attention,
                                                  ring_flash_attention)

        q, k, v = _qkv(seed=3)
        jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
        ref = np.asarray(reference_attention(jq, jk, jv, causal=causal))
        jrf = np.asarray(ring_flash_attention(
            jq, jk, jv, jmake_mesh({"sp": 8}), "sp", causal=causal,
            block_q=8, block_k=8))
        out = _joined(groups.run(8, tr.sp_attention, q, k, v, {"sp": 8},
                                 "ring-flash", causal))
        np.testing.assert_allclose(out, ref, rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(out, jrf, rtol=2e-4, atol=2e-5)

    def test_ring_flash_via_dispatch(self, groups):
        from nnstreamer_tpu.parallel.ring import (reference_attention,
                                                  sp_attention_fn)

        q, k, v = _qkv(seed=4)
        jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
        ref = np.asarray(reference_attention(jq, jk, jv, causal=True))
        jout = np.asarray(sp_attention_fn("ring-flash", jmake_mesh({"sp": 8}),
                                          "sp", causal=True)(jq, jk, jv))
        out = _joined(groups.run(8, tr.sp_attention, q, k, v, {"sp": 8},
                                 "ring-flash", True))
        np.testing.assert_allclose(out, ref, rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(out, jout, rtol=2e-4, atol=2e-5)

    def test_ring_under_jit(self, groups):
        """JAX's ring inside jit; the port's keeps the shard's shape."""
        q, k, v = _qkv(length=32)
        got = groups.run(8, tr.sp_attention, q, k, v, {"sp": 8}, "ring", False)
        assert all(g.shape == (2, 4, 4, 16) for g in got)
        assert _joined(got).shape == q.shape

    @pytest.mark.parametrize("mode", ["a2a", "a2a-flash"])
    def test_a2a_causal_mode(self, groups, mode):
        """Port-only: a2a with causal=True (the sequence-parallel prefill's
        a2a modes) against the dense causal oracle."""
        from nnstreamer_tpu.parallel.ring import reference_attention

        q, k, v = _qkv(h=8, seed=9)
        ref = np.asarray(reference_attention(
            *(jnp.asarray(a) for a in (q, k, v)), causal=True))
        out = _joined(groups.run(8, tr.sp_attention, q, k, v, {"sp": 8},
                                 mode, True))
        np.testing.assert_allclose(out, ref, rtol=2e-4, atol=2e-5)


def test_a2a_flash_attention_exact(groups):
    from nnstreamer_tpu.parallel.ring import a2a_attention, reference_attention

    rng = np.random.default_rng(6)
    q, k, v = [rng.standard_normal((1, 8, 64, 16)).astype(np.float32)
               for _ in range(3)]
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    ref = np.asarray(reference_attention(jq, jk, jv))
    jout = np.asarray(a2a_attention(jq, jk, jv, jmake_mesh({"sp": 8}), "sp",
                                    flash=True))
    out = _joined(groups.run(8, tr.sp_attention, q, k, v, {"sp": 8},
                             "a2a-flash", False))
    np.testing.assert_allclose(out, ref, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(out, jout, rtol=2e-4, atol=2e-5)


# -- the sequence-parallel prefill (test_causal_lm.py's mesh cases) --------- #

SPEC = "zoo://causal_lm?vocab=32&dim=32&heads=4&layers=2&max_len=16"


@pytest.fixture(scope="module")
def lm_bundle():
    from nnstreamer_tpu.models.zoo import get_model

    return get_model(SPEC)


@pytest.mark.parametrize("mode,world", [("ring", 8), ("ring-flash", 8),
                                        ("a2a", 4), ("a2a-flash", 4)])
def test_sp_prefill_then_decode_exact(groups, lm_bundle, mode, world):
    """Sequence-parallel prefill, then single-stream decode on the port's
    single-card step: logits equal the dense oracle throughout (rtol 2e-4 /
    atol 2e-5). ring over sp 8 is the JAX test's case; the other modes are
    the port's NNS_LM_SP_MODE values (a2a over sp 4: the model's 4 heads
    must divide the axis)."""
    from nnstreamer_tpu.models.causal_lm import lm_forward
    from nnstreamer_tpu_torch.models import causal_lm as plm
    from nnstreamer_tpu_torch.models.convert import causal_lm_params

    meta = lm_bundle.metadata
    rng = np.random.default_rng(9)
    p_, c = 8, 4
    tokens = rng.integers(0, meta["vocab"], (1, p_ + c)).astype(np.int32)
    oracle = np.asarray(lm_forward(lm_bundle.params, jnp.asarray(tokens),
                                   meta["heads"]))
    pn = _np(lm_bundle.params)
    got = groups.run(world, tr.sp_prefill, pn, meta["heads"],
                     meta["max_len"], {"sp": world}, tokens[:, :p_], mode)
    logits, k, v, pos = got[0]
    for other in got[1:]:  # every rank returns the same cache and logits
        for a, b in zip(other, got[0]):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(logits, oracle[:, p_ - 1], rtol=2e-4, atol=2e-5)
    params = causal_lm_params(pn, "cpu")
    k, v, pos = (torch.from_numpy(a) for a in (k, v, pos))
    for t in range(p_, p_ + c):
        lg, k, v, pos = plm.lm_decode_step(
            params, torch.from_numpy(tokens[:, t:t + 1]), k, v, pos,
            meta["heads"])
        np.testing.assert_allclose(lg.numpy(), oracle[:, t], rtol=2e-4,
                                   atol=2e-5, err_msg=f"step {t}")


def test_sp_prefill_rejects_indivisible_prompt(groups, lm_bundle):
    meta = lm_bundle.metadata
    err = groups.run(8, tr.sp_prefill, _np(lm_bundle.params), meta["heads"],
                     meta["max_len"], {"sp": 8}, np.zeros((1, 6), np.int32),
                     "ring")
    assert all(isinstance(e, str) and "divisible" in e for e in err), err


def test_sp_prefill_rejects_missing_axis(groups, lm_bundle):
    meta = lm_bundle.metadata
    err = groups.run(8, tr.sp_prefill, _np(lm_bundle.params), meta["heads"],
                     meta["max_len"], {"data": 8}, np.zeros((1, 8), np.int32),
                     "ring")
    assert all(isinstance(e, str) and "axis" in e for e in err), err


def test_prefill_flash_conflicts_with_mesh(groups):
    from nnstreamer_tpu.models.causal_lm import init_causal_lm

    params = init_causal_lm(jax.random.PRNGKey(0), vocab=32, d_model=16,
                            n_heads=2, n_layers=1, max_len=16)
    err = groups.run(8, tr.sp_prefill, _np(params), 2, 16, {"sp": 8},
                     np.zeros((1, 8), np.int32), "ring", True)
    assert all(isinstance(e, str) and "flash" in e for e in err), err


def test_prefill_sp_ring_flash_mode(groups):
    from nnstreamer_tpu.models.causal_lm import init_causal_lm, lm_forward

    params = init_causal_lm(jax.random.PRNGKey(0), vocab=32, d_model=16,
                            n_heads=2, n_layers=2, max_len=32)
    toks = np.asarray(np.random.default_rng(7).integers(0, 32, (1, 32)),
                      np.int32)
    want = np.asarray(lm_forward(params, toks, n_heads=2)[:, -1])
    got = groups.run(8, tr.sp_prefill, _np(params), 2, 32, {"sp": 8}, toks,
                     "ring-flash")
    for logits, _, _, _ in got:
        np.testing.assert_allclose(logits, want, rtol=2e-4, atol=2e-5)


# -- pipeline stages --------------------------------------------------------- #

def _stages(n_stages, d=8, seed=0):
    rng = np.random.default_rng(seed)
    per = [{"w": (rng.normal(size=(d, d)) / np.sqrt(d)).astype(np.float32),
            "b": rng.normal(size=(d,)).astype(np.float32)}
           for _ in range(n_stages)]
    return {k: np.stack([p[k] for p in per]) for k in ("w", "b")}


def _jax_stage_fn(params, h):
    return jnp.tanh(h @ params["w"] + params["b"])


class TestPipelineParallel:
    @pytest.mark.parametrize("n_micro", [None, 8, 16])
    def test_gpipe_exact(self, groups, n_micro):
        from nnstreamer_tpu.parallel import sequential_apply

        stacked = _stages(8)
        x = np.random.default_rng(1).normal(size=(16, 8)).astype(np.float32)
        want = np.asarray(sequential_apply(
            _jax_stage_fn, jax.tree_util.tree_map(jnp.asarray, stacked),
            jnp.asarray(x)))
        got = groups.run(8, tr.gpipe, stacked, x, {"stage": 8}, n_micro, True)
        for out in got:
            np.testing.assert_allclose(out, want, rtol=2e-5, atol=2e-6)

    def test_gpipe_2x4_mixed_mesh(self, groups):
        from nnstreamer_tpu.parallel import sequential_apply

        stacked = _stages(4)
        x = np.random.default_rng(2).normal(size=(8, 8)).astype(np.float32)
        want = np.asarray(sequential_apply(
            _jax_stage_fn, jax.tree_util.tree_map(jnp.asarray, stacked),
            jnp.asarray(x)))
        got = groups.run(8, tr.gpipe, stacked, x, {"stage": 4, "data": 2},
                         None, True)
        for out in got:
            np.testing.assert_allclose(out, want, rtol=2e-5, atol=2e-6)

    def test_gpipe_rejects_indivisible_batch(self, groups):
        err = groups.run(8, tr.gpipe, _stages(8), np.zeros((12, 8), np.float32),
                         {"stage": 8}, 8, False)
        assert all(isinstance(e, str) and "microbatch" in e for e in err), err


def test_gpipe_rejects_stage_count_mismatch(groups):
    """8 stacked stages on a 4-rank axis must raise, not run every other
    stage."""
    stacked = {"w": np.stack([np.eye(4, dtype=np.float32)] * 8)}
    err = groups.run(8, tr.gpipe, stacked, np.zeros((8, 4), np.float32),
                     {"stage": 4, "data": 2}, None, False)
    assert all(isinstance(e, str) and "stages" in e for e in err), err


# -- expert parallelism ------------------------------------------------------ #

def _moe_setup(b=2, s=16, d=8, h=16, e=4, seed=0, dtype=jnp.float32):
    from nnstreamer_tpu.parallel import init_moe_params

    params = init_moe_params(jax.random.PRNGKey(seed), d, h, e, dtype=dtype)
    x = jnp.asarray(np.random.default_rng(seed).normal(size=(b, s, d)),
                    dtype=dtype)
    return params, x


def _port_moe(params, x, cf):
    from nnstreamer_tpu_torch.models.convert import moe_params, tensor_tree
    from nnstreamer_tpu_torch.parallel import moe_apply

    y, aux = moe_apply(moe_params(_np(params), "cpu"),
                       tensor_tree(np.asarray(x), "cpu"), cf)
    return y, {k: v.numpy() for k, v in aux.items()}


class TestExpertParallel:
    def test_moe_sharded_equals_single_device(self, groups):
        from nnstreamer_tpu.parallel import moe_apply

        params, x = _moe_setup()
        want, aux_want = moe_apply(params, x)
        got = groups.run(8, tr.moe_ep, _np(params), np.asarray(x),
                         {"data": 2, "expert": 4}, 1.25)
        mine, mine_aux = _port_moe(params, x, 1.25)
        np.testing.assert_allclose(mine.numpy(), np.asarray(want), rtol=2e-4,
                                   atol=2e-5)
        for res in got:
            assert res["w1_local"] == (1, 8, 16)  # one expert a rank
            np.testing.assert_allclose(res["y"], np.asarray(want), rtol=2e-4,
                                       atol=2e-5)
            np.testing.assert_array_equal(res["aux"]["expert_counts"],
                                          np.asarray(aux_want["expert_counts"]))
            assert float(res["aux"]["dropped"]) == float(aux_want["dropped"])
            np.testing.assert_allclose(res["aux"]["load_balance_loss"],
                                       mine_aux["load_balance_loss"], rtol=1e-5)

    def test_moe_routing_properties(self):
        from nnstreamer_tpu.parallel import moe_apply

        params, x = _moe_setup(b=4, s=32)
        out, aux = _port_moe(params, x, 1.25)
        _, jaux = moe_apply(params, x, capacity_factor=1.25)
        n = 4 * 32
        counts = aux["expert_counts"]
        assert counts.sum() == n
        assert 0 <= float(aux["dropped"]) < n
        assert tuple(out.shape) == x.shape
        assert float(aux["load_balance_loss"]) >= 1.0 - 1e-3
        np.testing.assert_array_equal(counts, np.asarray(jaux["expert_counts"]))
        assert float(aux["dropped"]) == float(jaux["dropped"])

    def test_moe_capacity_drops_tokens(self):
        params, x = _moe_setup(b=2, s=32)
        _, tight = _port_moe(params, x, 0.25)
        _, loose = _port_moe(params, x, 4.0)
        assert float(tight["dropped"]) > 0
        assert float(loose["dropped"]) == 0

    def test_moe_bf16_routing_exact(self):
        """Routing bookkeeping stays float32 under bf16: > 256 tokens on an
        expert keep distinct slots. The oracle takes the same routing
        decisions and does the capacity bookkeeping in numpy."""
        import math

        from nnstreamer_tpu_torch.models.convert import moe_params, tensor_tree

        d, e, cf = 8, 4, 2.0
        params, x = _moe_setup(b=4, s=512, d=d, e=e, dtype=jnp.bfloat16)
        out, aux = _port_moe(params, x, cf)
        n = 4 * 512
        assert aux["expert_counts"].sum() == n
        pp = moe_params(_np(params), "cpu")
        xt = tensor_tree(np.asarray(x), "cpu").reshape(n, d)
        gates = torch.softmax((xt @ pp["router"]).to(torch.float32),
                              -1).double().numpy()
        expert, gate = np.argmax(gates, -1), np.max(gates, -1)
        cap = int(np.ceil(n / e * cf))
        slots = np.zeros(e, np.int64)
        xf = xt.double().numpy()
        w1 = pp["w1"].double().numpy()
        w2 = pp["w2"].double().numpy()
        want = np.zeros_like(xf)
        for i in range(n):
            ee = expert[i]
            if slots[ee] < cap:
                slots[ee] += 1
                h = xf[i] @ w1[ee]
                h = 0.5 * h * (1 + np.vectorize(math.erf)(h / np.sqrt(2)))
                want[i] = gate[i] * (h @ w2[ee])
        got = out.to(torch.float32).numpy().reshape(n, d)
        np.testing.assert_allclose(got, want, rtol=0.2, atol=0.2)


# -- the trainer's mesh= ----------------------------------------------------- #

def _linear_frames(n=6, batch=4, seed=0):
    rng = np.random.default_rng(seed)
    true_w = rng.normal(size=(8, 4)).astype(np.float32)
    xs = rng.normal(size=(n, batch, 8)).astype(np.float32)
    ys = np.argmax(xs @ true_w, axis=-1).astype(np.int32)
    return [(x, y) for x, y in zip(xs, ys)]


def test_trainer_mesh_data_parallel_equals_unsharded(groups):
    """mesh="data:2": each rank trains on its half of every batch, the
    gradients averaged over data; losses and params equal the unsharded
    trainer's within rtol 1e-5 / atol 1e-6."""
    w = (np.random.default_rng(3).normal(size=(8, 4)) * 0.1).astype(np.float32)
    frames = _linear_frames()
    want = groups.run(2, tr.trainer_run, w, frames, None, 0.05)[0]
    got = groups.run(2, tr.trainer_run, w, frames, "data:2", 0.05)
    for res in got:
        np.testing.assert_allclose(res["losses"], want["losses"], rtol=1e-5)
        np.testing.assert_allclose(res["params"], want["params"], rtol=1e-5,
                                   atol=1e-6)
    assert want["losses"][-1] < want["losses"][0]


def _caps():
    from nnstreamer_tpu_torch import core

    return core.Caps.tensors(core.TensorsConfig(
        core.TensorsInfo.from_strings("8:2,2", "float32,int32"), 30))


@pytest.mark.parametrize("bad", ["data", "data:", ":4", "data:x"])
def test_trainer_malformed_mesh_string_clear_error(bad):
    from nnstreamer_tpu_torch.graph import Pipeline
    from nnstreamer_tpu_torch.graph.pipeline import PipelineError

    p = Pipeline(device="cpu")
    src = p.add_new("appsrc", caps=_caps(),
                    data=[(np.zeros((2, 8), np.float32), np.zeros(2, np.int32))])
    t = p.add_new("tensor_trainer", model=(lambda prm, x: x @ prm,
                                           np.zeros((8, 4), np.float32)),
                  mesh=bad)
    Pipeline.link(src, t, p.add_new("fakesink"))
    with pytest.raises((PipelineError, ValueError), match="mesh"):
        p.run(timeout=30)


def test_trainer_empty_mesh_string_is_unsharded():
    from nnstreamer_tpu_torch.graph import Pipeline

    p = Pipeline(device="cpu")
    src = p.add_new("appsrc", caps=_caps(),
                    data=[(np.zeros((2, 8), np.float32),
                           np.zeros(2, np.int32))] * 2)
    t = p.add_new("tensor_trainer", model=(lambda prm, x: x @ prm,
                                           np.zeros((8, 4), np.float32)),
                  mesh="")
    Pipeline.link(src, t, p.add_new("fakesink"))
    p.run(timeout=60)
    assert len(t.losses) == 2
