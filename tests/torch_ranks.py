"""Rank functions for the port's parallel tests (tests/test_torch_parallel.py,
test_torch_tp_decode.py, test_torch_tp_prefill.py, test_torch_tp_engine.py,
test_torch_sharded_serving.py, test_torch_stream_transformer.py,
test_torch_moe_model.py).

Each runs on every rank of a ``parallel.launch.RankGroup`` on the CPU; the
launcher spawns fresh interpreters that import this module by name, so it
imports torch and the port only — never JAX, never a test module. Inputs
arrive as numpy (a JAX tree turned to numpy, or seeded arrays) and results
go back as numpy.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from nnstreamer_tpu_torch.models import causal_lm
from nnstreamer_tpu_torch.models.convert import causal_lm_params
from nnstreamer_tpu_torch.parallel import mesh as pmesh


def _mesh(axes):
    return pmesh.make_mesh(dict(axes))


def _lm(params_np, quant=False):
    params = causal_lm_params(params_np, "cpu")
    return causal_lm.quantize_lm_params(params) if quant else params


# -- mesh and collectives ---------------------------------------------------- #

def rank_info():
    from nnstreamer_tpu_torch.parallel.launch import rank_device

    return {"rank": dist.get_rank(), "world": dist.get_world_size(),
            "backend": str(dist.get_backend()), "device": str(rank_device()),
            "threads": torch.get_num_threads()}


def collectives(axes, axis):
    """Every helper of parallel/mesh.py on this rank's seeded values."""
    mesh = _mesh(axes)
    me = pmesh.axis_index(mesh, axis)
    n = pmesh.axis_size(mesh, axis)
    g = torch.Generator().manual_seed(10 + dist.get_rank())
    x = torch.randn(4, 6, generator=g)
    xi = torch.randint(-50, 50, (4, 6), generator=g, dtype=torch.int32)
    rot = [(j, (j - 1) % n) for j in range(n)]
    a2a_in = torch.arange(n * 3 * 2, dtype=torch.float32).reshape(n * 3, 2) \
        + 100 * dist.get_rank()
    return {"x": x, "xi": xi, "index": me, "size": n,
            "psum": pmesh.psum(x, mesh, axis),
            "psum_i": pmesh.psum(xi, mesh, axis),
            "pmax": pmesh.pmax(x, mesh, axis),
            "ppermute": pmesh.ppermute(x, mesh, axis, rot),
            "a2a_in": a2a_in,
            "all_to_all": pmesh.all_to_all(a2a_in, mesh, axis, 0, 1),
            "all_gather": pmesh.all_gather(x, mesh, axis, 0),
            "broadcast": pmesh.broadcast(x, mesh, axis, 1 % n),
            "shape": pmesh.mesh_shape(mesh)}


def make_mesh_error(axes):
    try:
        _mesh(axes)
    except ValueError as e:
        return str(e)
    return None


def auto_mesh(n_devices, model_parallel):
    return pmesh.mesh_shape(pmesh.auto_mesh_2d(n_devices, model_parallel))


def raise_on(rank):
    if dist.get_rank() == rank:
        raise ValueError(f"deliberate failure on rank {rank}")
    return dist.get_rank()


def hang_collective(rank):
    """Rank ``rank`` enters an all_reduce no other rank joins."""
    if dist.get_rank() == rank:
        t = torch.ones(1)
        dist.all_reduce(t)
        return float(t)
    return None


# -- tensor-parallel decode and prefill ------------------------------------ #

def tp_slices(params_np, n_heads, axes, quant):
    """This rank's tp_shard_params leaves as numpy."""
    from nnstreamer_tpu_torch.parallel.tp_decode import tp_shard_params

    mesh = _mesh(axes)
    return tp_shard_params(_lm(params_np, quant), n_heads, mesh)


def tp_shard_error(params_np, n_heads, axes):
    from nnstreamer_tpu_torch.parallel.tp_decode import tp_shard_params

    try:
        tp_shard_params(_lm(params_np), n_heads, _mesh(axes))
    except ValueError as e:
        return str(e)
    return None


def tp_generate(params_np, n_heads, max_len, axes, quant, first, kc, vc, pos,
                n_steps, n_layers, batch):
    """TP greedy decode from a single-device prefill's cache, resharded."""
    from nnstreamer_tpu_torch.parallel.tp_decode import (
        make_tp_generate, tp_shard_cache, tp_shard_params)

    mesh = _mesh(axes)
    tp = tp_shard_params(_lm(params_np, quant), n_heads, mesh)
    kc_tp, vc_tp = tp_shard_cache(kc, vc, n_layers, batch, n_heads, mesh)
    gen = make_tp_generate(n_heads, max_len, mesh)
    return gen(tp, torch.from_numpy(first), kc_tp, vc_tp,
               torch.from_numpy(pos), n_steps)


def tp_generate_twice(params_np, n_heads, max_len, axes, first, kc, vc, pos,
                      n_steps, n_layers, batch):
    """Two calls of one generator (one program), then one past capacity."""
    from nnstreamer_tpu_torch.parallel.tp_decode import (
        make_tp_generate, tp_shard_cache, tp_shard_params)

    mesh = _mesh(axes)
    tp = tp_shard_params(_lm(params_np), n_heads, mesh)
    gen = make_tp_generate(n_heads, max_len, mesh)
    outs = []
    for _ in range(2):
        kc_tp, vc_tp = tp_shard_cache(kc, vc, n_layers, batch, n_heads, mesh)
        outs.append(gen(tp, torch.from_numpy(first), kc_tp, vc_tp,
                        torch.from_numpy(pos), n_steps))
    try:
        gen(tp, torch.from_numpy(first), kc_tp, vc_tp, torch.from_numpy(pos),
            max_len + 1)
        overflow = None
    except ValueError as e:
        overflow = str(e)
    return {"outs": outs, "programs": len(gen.compiled), "overflow": overflow}


def tp_prefill_then_generate(params_np, n_heads, max_len, axes, quant,
                             prompt, true_len, n_steps):
    """make_tp_prefill → argmax → make_tp_generate; the rank's caches."""
    from nnstreamer_tpu_torch.parallel.tp_decode import (
        make_tp_generate, tp_shard_params)
    from nnstreamer_tpu_torch.parallel.tp_prefill import make_tp_prefill

    mesh = _mesh(axes)
    tp = tp_shard_params(_lm(params_np, quant), n_heads, mesh)
    logits, kc, vc, pos = make_tp_prefill(n_heads, max_len, mesh)(
        tp, prompt, true_len=true_len)
    out = {"logits": logits, "kc": kc.clone(), "vc": vc.clone(), "pos": pos}
    if n_steps:
        first = torch.argmax(logits, -1)[:, None].to(torch.int32)
        out["first"] = first[:, 0]
        out["tokens"] = make_tp_generate(n_heads, max_len, mesh)(
            tp, first, kc, vc, pos, n_steps)
    return out


def tp_prefill_vs_window(params_np, n_heads, max_len, axes, prompt):
    """The rank's TP prefill K/V beside the port's single-card admit prefill
    (``lm_prefill_window``, row by row) cut to the rank's heads: (tp K,
    single K, tp V, single V, tp logits, single logits)."""
    from nnstreamer_tpu_torch.parallel.tp_decode import tp_shard_params
    from nnstreamer_tpu_torch.parallel.tp_prefill import make_tp_prefill

    mesh = _mesh(axes)
    n = pmesh.axis_size(mesh, "model")
    r = pmesh.axis_index(mesh, "model")
    hn = n_heads // n
    params = _lm(params_np)
    tp = tp_shard_params(params, n_heads, mesh)
    b, t = prompt.shape
    logits, kc, vc, _ = make_tp_prefill(n_heads, max_len, mesh)(tp, prompt)
    n_layers = kc.shape[0] // (b * hn)
    view = (n_layers, b, hn) + tuple(kc.shape[-2:])
    ks, vs, ls = [], [], []
    for row in range(b):
        lg, k1, v1, _ = causal_lm.lm_prefill_window(
            params, torch.from_numpy(prompt[row:row + 1]), t, n_heads, max_len)
        k1 = k1.view(n_layers, n_heads, *k1.shape[-2:])[:, r * hn:(r + 1) * hn]
        v1 = v1.view(n_layers, n_heads, *v1.shape[-2:])[:, r * hn:(r + 1) * hn]
        ks.append(k1)
        vs.append(v1)
        ls.append(lg[0])
    return (kc.view(view), torch.stack(ks, 1), vc.view(view),
            torch.stack(vs, 1), logits, torch.stack(ls))


def tp_step_vs_single(params_np, n_heads, max_len, axes, quant, prompts,
                      tokens):
    """One decode step over slots holding ``prompts`` (admitted by the
    single-card window prefill), TP against single-card: (tp logits,
    single logits)."""
    from nnstreamer_tpu_torch.parallel.tp_decode import (
        head_major_relayout, tp_decode_step_slots, tp_shard_params)

    mesh = _mesh(axes)
    n = pmesh.axis_size(mesh, "model")
    r = pmesh.axis_index(mesh, "model")
    params = _lm(params_np, quant)
    tp = tp_shard_params(params, n_heads, mesh)
    n_layers = params["ln1"].shape[0]
    hd = params["embed"].shape[1] // n_heads
    s_ = len(prompts)
    kc = torch.zeros((s_, n_layers * n_heads, max_len, hd))
    vc = torch.zeros_like(kc)
    pos = torch.zeros((s_, 1), dtype=torch.int32)
    for i, p in enumerate(prompts):
        _, kc[i], vc[i], pos[i] = causal_lm.lm_prefill_window(
            params, torch.from_numpy(p[None]), len(p), n_heads, max_len)
    hn = n_heads // n
    kt = torch.stack([head_major_relayout(kc[i], n_layers, 1, n, hn)[r]
                      for i in range(s_)]).contiguous()
    vt = torch.stack([head_major_relayout(vc[i], n_layers, 1, n, hn)[r]
                      for i in range(s_)]).contiguous()
    tok = torch.from_numpy(tokens).reshape(s_, 1, 1)
    lt, _, _, _ = tp_decode_step_slots(tp, tok, kt, vt, pos.clone(), n_heads,
                                       mesh)
    ls, _, _, _ = causal_lm.lm_decode_step_slots(params, tok, kc, vc,
                                                 pos.clone(), n_heads)
    return lt, ls


def tp_prefill_error(params_np, n_heads, max_len, axes, prompt, true_len):
    from nnstreamer_tpu_torch.parallel.tp_decode import tp_shard_params
    from nnstreamer_tpu_torch.parallel.tp_prefill import make_tp_prefill

    mesh = _mesh(axes)
    tp = tp_shard_params(_lm(params_np), n_heads, mesh)
    try:
        make_tp_prefill(n_heads, max_len, mesh)(tp, prompt, true_len=true_len)
    except ValueError as e:
        return str(e)
    return None


def int8_row_sharded(x, wq, w_scale, axes):
    """ops/int8's TP helpers on this rank's column slice of x and row slice
    of wq: (codes, scales, int32 partial, int32 sum, result)."""
    from nnstreamer_tpu_torch.ops import int8 as i8

    mesh = _mesh(axes)
    n = pmesh.axis_size(mesh, "model")
    r = pmesh.axis_index(mesh, "model")
    k = x.shape[-1] // n
    xl = torch.from_numpy(np.ascontiguousarray(x[..., r * k:(r + 1) * k]))
    wl = torch.from_numpy(np.ascontiguousarray(wq[r * k:(r + 1) * k]))
    q, s = i8.quant_act_global(xl, mesh, "model")
    part = i8.int8_partial(q, wl)
    return {"q": q, "s": s, "partial": part,
            "sum": pmesh.psum(part, mesh, "model"),
            "out": i8.int8_row_sharded_matmul(
                xl, wl, torch.from_numpy(w_scale), mesh, "model")}


# -- the TP engine ----------------------------------------------------------- #

def _submit_all(eng, jobs):
    return [eng.submit(np.asarray(p, np.int32), max_new=m, **kw)
            for p, m, kw in jobs]


def tp_engine(params_np, n_heads, max_len, axes, quant, jobs, engine_kw):
    """TPLMEngine over ``jobs`` [(prompt, max_new, submit kwargs)]: the
    tokens per job, the stats and the lockstep checks made."""
    from nnstreamer_tpu_torch.serving import TPLMEngine

    mesh = _mesh(axes)
    eng = TPLMEngine(_lm(params_np, quant), n_heads, max_len, mesh,
                     **engine_kw)
    rids = _submit_all(eng, jobs)
    res = eng.run()
    return {"tokens": [res[r] for r in rids], "stats": dict(eng.stats),
            "lockstep": eng.lockstep_checks,
            "kc_shape": tuple(eng._kc.shape)}


def tp_engine_error(params_np, n_heads, max_len, axes, engine_kw, env):
    import os

    from nnstreamer_tpu_torch.serving import TPLMEngine

    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        eng = TPLMEngine(_lm(params_np), n_heads, max_len, _mesh(axes),
                         **engine_kw)
        return {"error": None, "paged": eng._kv is not None}
    except (ValueError, RuntimeError) as e:
        return {"error": str(e), "paged": None}
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def tp_engine_diverging(params_np, n_heads, max_len, axes):
    """Rank 1 submits a different prompt: every rank must raise."""
    from nnstreamer_tpu_torch.serving import TPLMEngine
    from nnstreamer_tpu_torch.serving.tp_engine import LockstepError

    eng = TPLMEngine(_lm(params_np), n_heads, max_len, _mesh(axes),
                     n_slots=2, chunk=2)
    n = 5 if dist.get_rank() == 1 else 4
    eng.submit(np.arange(n, dtype=np.int32), max_new=3)
    try:
        eng.run()
    except LockstepError as e:
        return str(e)
    return None


def tp_engine_deadlines(params_np, n_heads, max_len, axes):
    """Rank 0's clock decides: rank 0's deadline has passed, the others'
    have not; every rank sheds the request."""
    from nnstreamer_tpu_torch.resilience.policy import Deadline
    from nnstreamer_tpu_torch.serving import TPLMEngine

    eng = TPLMEngine(_lm(params_np), n_heads, max_len, _mesh(axes),
                     n_slots=2, chunk=2)
    late = Deadline.after_s(-1.0 if dist.get_rank() == 0 else 3600.0)
    rid = eng.submit(np.arange(6, dtype=np.int32), max_new=3, deadline=late)
    ok = eng.submit(np.arange(5, dtype=np.int32), max_new=3)
    res = eng.run()
    return {"shed": res[rid], "served": res[ok]}


class Groups:
    """Rank groups by world size for one test module (a module-scoped
    fixture's value): ``groups(world)`` starts a CPU group on first use and
    again after a failure closed it; ``close()`` stops them all."""

    def __init__(self, timeout: float = 60.0) -> None:
        self._groups = {}
        self._timeout = timeout

    def __call__(self, world: int):
        from nnstreamer_tpu_torch.parallel.launch import RankGroup

        g = self._groups.get(world)
        if g is None or g.closed:
            g = self._groups[world] = RankGroup(world, device="cpu",
                                                timeout=self._timeout)
        return g

    def run(self, world: int, fn, *args):
        return self(world).run(fn, *args)

    def close(self) -> None:
        for g in self._groups.values():
            g.close()


# -- sharding, sharded steps and checkpoints -------------------------------- #

def _pl(placement):
    """A placement's name, the same in every torch version."""
    from torch.distributed.tensor import Shard

    if isinstance(placement, Shard):
        return f"Shard(dim={placement.dim})"
    return f"{type(placement).__name__}()"


def _placements(tree):
    from nnstreamer_tpu_torch.parallel.sharding import tree_flatten

    flat, _ = tree_flatten(tree)
    return {p: [_pl(pl) for pl in leaf.placements] for p, leaf in flat}


def shard_layout(params_np, axes):
    from nnstreamer_tpu_torch.parallel import shard_params
    from nnstreamer_tpu_torch.parallel.sharding import tree_flatten

    sharded = shard_params(params_np, _mesh(axes))
    return {"placements": _placements(sharded),
            "local": {p: tuple(v.to_local().shape)
                      for p, v in tree_flatten(sharded)[0]}}


def _matmul(p, x):
    return x @ p


def sharded_infer(w, x, axes):
    from nnstreamer_tpu_torch.parallel import make_sharded_infer_step

    fn, params = make_sharded_infer_step(_matmul, w, _mesh(axes))
    return fn(params, x)


def sharded_train(w, x, y, axes, steps):
    from nnstreamer_tpu_torch.parallel import make_sharded_train_step

    step, params, opt = make_sharded_train_step(_matmul, w, _mesh(axes))
    losses = []
    for _ in range(steps):
        params, opt, loss = step(params, opt, x, y)
        losses.append(float(loss))
    return {"losses": losses, "placements": [_pl(p) for p in params.placements],
            "params": _full(params)}


def _mlp(p, x):
    return torch.tanh(x @ p["w1"]) @ p["w2"]


def _setup_mlp(w, axes):
    from nnstreamer_tpu_torch.parallel import make_sharded_train_step

    mesh = _mesh(axes)
    step, params, opt = make_sharded_train_step(_mlp, w, mesh)
    return mesh, step, params, opt


def _run(step, params, opt, x, y, n):
    loss = None
    for _ in range(n):
        params, opt, loss = step(params, opt, x, y)
    return params, opt, float(loss)


def _full(tree):
    from nnstreamer_tpu_torch.parallel.sharding import full_value, tree_map

    return tree_map(full_value, tree)


def ckpt_resume(w, x, y, axes, path, axes_b):
    """Train 4 straight; train 2, save, restore (onto ``axes_b``), train 2."""
    from nnstreamer_tpu_torch.parallel import (make_sharded_train_step,
                                               restore_sharded_state,
                                               save_sharded_state)

    _, step, params, opt = _setup_mlp(w, axes)
    p_ref, _, loss_ref = _run(step, params, opt, x, y, 4)
    _, step2, params2, opt2 = _setup_mlp(w, axes)
    params2, opt2, _ = _run(step2, params2, opt2, x, y, 2)
    save_sharded_state(path, params2, opt2)
    mesh_b = _mesh(axes_b)
    step_b, pb_init, ob_init = make_sharded_train_step(_mlp, w, mesh_b)
    pr, osr = restore_sharded_state(path, pb_init, mesh=mesh_b,
                                    opt_state_like=ob_init)
    from nnstreamer_tpu_torch.parallel.sharding import tree_flatten

    placements = _placements(pr)
    meshes = {p: tuple(v.device_mesh.mesh.shape) for p, v in tree_flatten(pr)[0]}
    p_res, _, loss_res = _run(step_b, pr, osr, x, y, 2)
    return {"loss_ref": loss_ref, "loss_res": loss_res, "p_ref": _full(p_ref),
            "p_res": _full(p_res), "placements": placements,
            "want_placements": _placements(pb_init), "meshes": meshes}


def ckpt_partial(w, axes, path):
    """Params-only save with a host restore; full save with a params-only
    restore; params-only save against an opt template."""
    from nnstreamer_tpu_torch.parallel import (restore_sharded_state,
                                               save_sharded_state)

    mesh, _, params, opt = _setup_mlp(w, axes)
    out = {"params": _full(params)}
    save_sharded_state(path + "/ponly", params)
    host, host_opt = restore_sharded_state(path + "/ponly", params)
    out["host"] = host
    out["host_is_numpy"] = all(isinstance(v, np.ndarray) for v in host.values())
    out["host_opt"] = host_opt
    save_sharded_state(path + "/full", params, opt)
    pr, osr = restore_sharded_state(path + "/full", params, mesh=mesh)
    out["full_params_only"] = _full(pr)
    out["full_opt"] = osr
    pr2, osr2 = restore_sharded_state(path + "/ponly", params, mesh=mesh,
                                      opt_state_like=opt)
    out["ponly_params"] = _full(pr2)
    out["ponly_opt"] = osr2
    try:
        save_sharded_state(path + "/x.msgpack", params)
        out["msgpack"] = None
    except ValueError as e:
        out["msgpack"] = str(e)
    return out


def ckpt_from_orbax(w, axes, path):
    """Restore the JAX package's orbax directory at ``path`` (params and
    optax's sgd state) onto this mesh with the port's own train state as
    the template."""
    from nnstreamer_tpu_torch.parallel import restore_sharded_state

    mesh, _, params, opt = _setup_mlp(w, axes)
    pr, osr = restore_sharded_state(path, params, mesh=mesh, opt_state_like=opt)
    return {"params": _full(pr), "trace": {k: _full(v["0"]["trace"])
                                           for k, v in osr.items()},
            "placements": _placements(pr), "want_placements": _placements(params),
            "trace_placements": {k: _placements(v["0"]) for k, v in osr.items()},
            "want_trace_placements": {k: _placements(v["0"]) for k, v in opt.items()}}


# -- sequence parallelism ---------------------------------------------------- #

def sp_attention(q, k, v, axes, mode, causal):
    """This rank's output shard of a sequence-parallel attention mode over
    the whole q, k, v (each rank cuts its own shard); also the flash
    kernel's launches (0 on the CPU: the plain version runs)."""
    from nnstreamer_tpu_torch.parallel.ring import (a2a_attention,
                                                    ring_attention,
                                                    ring_flash_attention)

    mesh = _mesh(axes)
    n = pmesh.axis_size(mesh, "sp")
    r = pmesh.axis_index(mesh, "sp")
    ll = q.shape[2] // n

    def shard(a):
        return torch.from_numpy(np.ascontiguousarray(a[:, :, r * ll:(r + 1) * ll]))

    qs, ks, vs = shard(q), shard(k), shard(v)
    if mode == "ring":
        return ring_attention(qs, ks, vs, mesh, "sp", causal=causal)
    if mode == "ring-flash":
        return ring_flash_attention(qs, ks, vs, mesh, "sp", causal=causal,
                                    block_q=8, block_k=8)
    return a2a_attention(qs, ks, vs, mesh, "sp", flash=mode == "a2a-flash",
                         causal=causal)


def sp_error(q, axes, mode):
    from nnstreamer_tpu_torch.parallel.ring import sp_attention_fn

    mesh = _mesh(axes)
    t = torch.from_numpy(q)
    try:
        sp_attention_fn(mode, mesh, "sp")(t, t, t)
    except ValueError as e:
        return str(e)
    return None


def sp_prefill(params_np, n_heads, max_len, axes, tokens, mode, flash=None,
               sp_axis="sp"):
    """``lm_prefill(mesh=)`` under NNS_LM_SP_MODE=mode; an error's text."""
    import os

    mesh = _mesh(axes)
    os.environ["NNS_LM_SP_MODE"] = mode
    try:
        return causal_lm.lm_prefill(_lm(params_np), torch.from_numpy(tokens),
                                    n_heads, max_len, flash=flash, mesh=mesh,
                                    sp_axis=sp_axis)
    except ValueError as e:
        return str(e)
    finally:
        os.environ.pop("NNS_LM_SP_MODE", None)


# -- pipeline stages and experts --------------------------------------------- #

def _stage_tanh_bias(p, h):
    return torch.tanh(h @ p["w"] + p["b"])


def _stage_matmul(p, h):
    return h @ p["w"]


def gpipe(stacked_np, x, axes, n_micro, place):
    from nnstreamer_tpu_torch.parallel import (make_gpipe_apply,
                                               shard_stage_params)
    from nnstreamer_tpu_torch.models.convert import stage_params

    mesh = _mesh(axes)
    stacked = stage_params(stacked_np, "cpu")
    if place:
        stacked = shard_stage_params(stacked, mesh)
    fn = _stage_tanh_bias if "b" in stacked_np else _stage_matmul
    pp = make_gpipe_apply(fn, mesh, n_microbatches=n_micro)
    try:
        return pp(stacked, torch.from_numpy(x))
    except ValueError as e:
        return str(e)


def moe_ep(params_np, x, axes, capacity_factor):
    from nnstreamer_tpu_torch.models.convert import moe_params
    from nnstreamer_tpu_torch.parallel import make_expert_parallel_moe

    mesh = _mesh(axes)
    fn, placed = make_expert_parallel_moe(moe_params(params_np, "cpu"), mesh,
                                          capacity_factor=capacity_factor)
    try:
        y, aux = fn(placed, torch.from_numpy(x))
    except ValueError as e:
        return str(e)
    return {"y": y, "aux": aux,
            "w1_local": tuple(placed["w1"].to_local().shape)}


# -- the trainer's mesh= ----------------------------------------------------- #

def trainer_run(w, frames, mesh, lr):
    """A (fn, params) linear model trained by ``tensor_trainer`` in a
    pipeline on this rank: its losses and final params."""
    from nnstreamer_tpu_torch import core
    from nnstreamer_tpu_torch.graph import Pipeline

    b, k = frames[0][0].shape
    caps = core.Caps.tensors(core.TensorsConfig(
        core.TensorsInfo.from_strings(f"{k}:{b},{b}", "float32,int32"), 30))
    p = Pipeline(device="cpu")
    src = p.add_new("appsrc", caps=caps, data=list(frames))
    tr = p.add_new("tensor_trainer", model=(lambda prm, x: x @ prm,
                                            w.copy()),
                   learning_rate=lr, optimizer="sgd", mesh=mesh)
    sink = p.add_new("tensor_sink")
    Pipeline.link(src, tr, sink)
    p.run(timeout=120)
    return {"losses": list(tr.losses), "params": tr.params}


# -- sharded serving and the transformer families --------------------------- #

def _zoo(spec, variables):
    """A fresh zoo bundle on this rank's device, with the JAX bundle's
    ``variables`` (numpy) when given."""
    from nnstreamer_tpu_torch.models.convert import load_flax
    from nnstreamer_tpu_torch.models.zoo import get_model
    from nnstreamer_tpu_torch.parallel.launch import rank_device

    b = get_model(spec, device=rank_device(), fresh=True)
    return load_flax(b, variables) if variables is not None else b


def _any_mesh(axes):
    return _mesh(axes) if axes else pmesh.auto_mesh_2d()


def _lead_filter(served, calls):
    """Rank 0 opens a torch-cuda filter on ``served`` and returns
    ``calls(filter)``; closing it stops the session. Every other rank
    follows and returns its invoke count."""
    from nnstreamer_tpu_torch.filters.base import FilterProps
    from nnstreamer_tpu_torch.filters.torch_cuda import TorchCudaFilter
    from nnstreamer_tpu_torch.parallel.leader import follow

    if dist.get_rank() != 0:
        return follow(served)
    filt = TorchCudaFilter()
    filt.open(FilterProps(model=served, device="cpu"))
    try:
        return calls(filt)
    finally:
        filt.close()


def _invoke(filt, x):
    from nnstreamer_tpu_torch.core.buffer import TensorMemory

    return filt.invoke([TensorMemory(torch.from_numpy(x))])[0].host()


def sharded_uneven(spec, variables, axes, xs):
    """The served sharded bundle through the filter on batches the data
    axis does not divide; also whether the filter captured it."""
    from nnstreamer_tpu_torch.core.graphs import CapturedFn
    from nnstreamer_tpu_torch.parallel import sharded_bundle

    served = sharded_bundle(_zoo(spec, variables), _any_mesh(axes))
    return _lead_filter(served, lambda f: {
        "outs": [_invoke(f, x) for x in xs],
        "captured": isinstance(f._fn, CapturedFn),
        "batch_multiple": served.metadata["batch_multiple"],
        "name": served.name})


def sharded_reload(spec, spec2, v1, v2, axes, x):
    """Hot swaps on the leader's filter: the unsharded base → sharded b1 →
    sharded b2 → the unsharded base; each output and the filter's input
    placement after each swap."""
    from nnstreamer_tpu_torch.parallel import sharded_bundle

    mesh = _any_mesh(axes)
    b1, b2 = _zoo(spec, v1), _zoo(spec2, v2)
    s1, s2 = sharded_bundle(b1, mesh), sharded_bundle(b2, mesh)

    def calls(f):
        out = {"s1": _invoke(f, x)}
        f.reload_model(s2)
        out["s2"] = _invoke(f, x)
        out["placed_s2"] = str(f._device) == str(s2.metadata["input_sharding"])
        f.reload_model(b1)
        out["plain"] = _invoke(f, x)
        out["placed_plain"] = str(f._device)
        f.reload_model(s1)
        out["s1_again"] = _invoke(f, x)
        return out

    return _lead_filter(s1, calls)


def leader_fails(spec, axes, how):
    """The leader raises (``how`` "raise") or hangs past the collective
    timeout ("hang") before its first invoke; the followers wait for it."""
    import time

    from nnstreamer_tpu_torch.parallel import sharded_bundle
    from nnstreamer_tpu_torch.parallel.leader import follow

    served = sharded_bundle(_zoo(spec, None), _any_mesh(axes))
    if dist.get_rank() != 0:
        return follow(served)
    if how == "raise":
        raise RuntimeError("leader failed before its first invoke")
    time.sleep(3600)
    return None


def follower_calls(spec, axes):
    """A follower calling the served bundle directly is refused."""
    from nnstreamer_tpu_torch.parallel import sharded_bundle

    served = sharded_bundle(_zoo(spec, None), _any_mesh(axes))
    if dist.get_rank() == 0:
        served.metadata["session"].stop()
        return None
    try:
        served.apply(torch.zeros(1))
    except RuntimeError as e:
        served.metadata["session"].follow()
        return str(e)
    return None


def ep_serve(spec, variables, axes, x):
    """``ep_bundle`` served through the leader's filter."""
    from nnstreamer_tpu_torch.models.moe_transformer import ep_bundle

    served = ep_bundle(_zoo(spec, variables), _mesh(axes))
    return _lead_filter(served, lambda f: {"y": _invoke(f, x),
                                           "name": served.name})


def ep_infer(spec, variables, axes, x, dp_axis="data", metrics=False):
    """``make_ep_infer`` on the whole batch (the error text when it
    refuses); with ``metrics`` the router metrics too."""
    from nnstreamer_tpu_torch.models.moe_transformer import make_ep_infer

    infer, placed = make_ep_infer(_zoo(spec, variables), _mesh(axes),
                                  dp_axis=dp_axis)
    try:
        out = infer(placed, torch.from_numpy(x), metrics=metrics)
    except ValueError as e:
        return str(e)
    local = {k: tuple(v.to_local().shape) for k, v in placed.items()
             if k.endswith(("w1", "w2"))}
    if metrics:
        return {"y": out[0], "metrics": out[1], "local": local}
    return {"y": out, "local": local}


def ep_shardings(spec, axes, n_experts):
    """``ep_param_shardings`` of the bundle's state: path → placements."""
    from nnstreamer_tpu_torch.models.moe_transformer import ep_param_shardings

    b = _zoo(spec, None)
    sh = ep_param_shardings(b.module.state_dict(), _mesh(axes), n_experts)
    return {k: [_pl(p) for p in v] for k, v in sh.items()}


def sp_ep_infer(spec, variables, axes, x, mode, metrics=False):
    """``make_sp_ep_infer`` on the whole input (the error text when it
    refuses), the router metrics when asked, and this rank's flash
    launches (0 on the CPU)."""
    from nnstreamer_tpu_torch.models.moe_transformer import make_sp_ep_infer

    from nnstreamer_tpu_torch.ops.kernels import flash_attention as fa

    infer, placed = make_sp_ep_infer(_zoo(spec, variables), _mesh(axes),
                                     sp_mode=mode)
    fa.flash_attention.launches = 0
    try:
        out = infer(placed, torch.from_numpy(x), metrics=metrics)
    except ValueError as e:
        return str(e)
    res = {"y": out[0], "metrics": out[1]} if metrics else {"y": out}
    res["launches"] = fa.flash_attention.launches
    return res


def sp_apply(spec, variables, axes, x, mode):
    """``make_sp_apply``'s forward of the whole input (the error text when
    it refuses) and the flash kernel's launches on this rank."""
    from nnstreamer_tpu_torch.models.stream_transformer import make_sp_apply
    from nnstreamer_tpu_torch.ops.kernels import flash_attention as fa

    apply, params = make_sp_apply(_zoo(spec, variables), _mesh(axes), mode)
    fa.flash_attention.launches = 0
    try:
        y = apply(params, torch.from_numpy(x))
    except ValueError as e:
        return str(e)
    return {"y": y, "launches": fa.flash_attention.launches}
