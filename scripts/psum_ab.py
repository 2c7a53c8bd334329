"""psum/pmax under gloo on one card: all_reduce against all_gather and a
local reduction, in turns, inside the TP decode step.

    python3 scripts/psum_ab.py

On 2 and then 4 ranks sharing the card (gloo, parallel/launch.py), builds
the bench LM's TP slices (V 8192, d 1024, 16 heads, 8 layers; float32 and
w8a8) and times 20 TP decode steps over 8 slots with each form of
``parallel.mesh``'s reduction: "gather" (the module's own form for gloo on
CUDA tensors: all_gather, then the sum or max in coordinate order) and
"reduce" (gloo's all_reduce, put in its place by this script for its
turns), in the order gather, reduce, reduce, gather, gather, reduce; prints
each turn's ms a step (the slowest rank's) and the card. Run it from the
root of the tree; exits non-zero without a card.
"""
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import torch  # noqa: E402

ORDER = ("gather", "reduce", "reduce", "gather", "gather", "reduce")
STEPS = 20


def _all_reduce_form(x, mesh, axis, op, name):
    """``mesh._reduce`` through gloo's all_reduce (the "reduce" turns)."""
    import torch.distributed as dist

    from nnstreamer_tpu_torch.parallel import mesh as pmesh

    out = x.contiguous().clone()
    if pmesh.axis_size(mesh, axis) > 1:
        dist.all_reduce(out, op=op, group=pmesh.axis_group(mesh, axis))
    return out


def steps(quant, order, n_steps):
    import torch.distributed as dist

    import chip_smoke as cs
    from nnstreamer_tpu_torch.parallel import make_mesh
    from nnstreamer_tpu_torch.parallel import mesh as pmesh
    from nnstreamer_tpu_torch.parallel.tp_decode import (tp_decode_step_slots,
                                                         tp_shard_params)

    cfg = cs._par_cfg()
    mesh = make_mesh({"model": dist.get_world_size()})
    v, d, h, n_layers = cfg["dims"]
    tp = tp_shard_params(cs._par_params(cfg, quant), h, mesh)
    n = dist.get_world_size()
    kc = torch.zeros((8, n_layers * h // n, cfg["max_len"], d // h), device="cuda")
    vc = torch.zeros_like(kc)
    tok = torch.randint(0, v, (8, 1, 1), dtype=torch.int32, device="cuda")
    pos = torch.full((8, 1), 300, dtype=torch.int32, device="cuda")
    gather_form = pmesh._reduce
    out = []
    try:
        for variant in order:
            pmesh._reduce = gather_form if variant == "gather" else _all_reduce_form
            tp_decode_step_slots(tp, tok, kc, vc, pos.clone(), h, mesh)
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            for _ in range(n_steps):
                tp_decode_step_slots(tp, tok, kc, vc, pos.clone(), h, mesh)
            torch.cuda.synchronize()
            out.append((variant, (time.perf_counter() - t0) * 1e3 / n_steps))
    finally:
        pmesh._reduce = gather_form
    return out


if __name__ == "__main__":
    if not torch.cuda.is_available():
        print("psum_ab: no CUDA device", file=sys.stderr)
        sys.exit(1)
    from nnstreamer_tpu_torch.parallel.launch import RankGroup

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    for world in (2, 4):
        with RankGroup(world, device="cuda", timeout=120) as g:
            for quant in ("float32", "w8a8"):
                res = g.run(steps, quant, list(ORDER), STEPS)
                turns = [(v, round(max(r[i][1] for r in res), 3))
                         for i, (v, _) in enumerate(res[0])]
                mean = {v: round(sum(t for u, t in turns if u == v) / ORDER.count(v), 3)
                        for v in ("gather", "reduce")}
                print(f"world {world} {quant}: ms a step by turn {turns}; mean {mean}",
                      flush=True)
