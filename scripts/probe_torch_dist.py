"""Which torch.distributed collectives gloo takes on CUDA tensors.

    python3 scripts/probe_torch_dist.py [--world 2] [--device cuda]

Starts ``--world`` ranks on one card (rank r on cuda:(r % cards)) with the
gloo backend through nnstreamer_tpu_torch/parallel/launch.py and tries, on
tensors on the card: all_reduce SUM and MAX in float32 and int32, broadcast,
all_gather (a list) and all_gather_into_tensor (one tensor),
all_to_all_single (equal splits, and one non-empty split each way: a
rotation), and send/recv; ``--cases a,b`` runs some. For each it prints whether the call took
the tensor, the error if not, its time (ms a call, the mean of 20 after 3
warm-ups, host clock around a synchronised call: gloo stages a CUDA tensor
through the host inside the call) and whether every rank got bit-equal
results. Prints the card's name and power limit; the last line is one JSON
object of the findings. ``--device cpu`` runs the same on CPU tensors.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

#: elements of the probed float tensor: one (8, 1024) float32 activation,
#: a TP decode step's all_reduce at the serving width
N = 8 * 1024
REPS, WARM = 20, 3


def _time(fn) -> float:
    for _ in range(WARM):
        fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(REPS):
        fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / REPS


def probe_rank(name: str) -> dict:
    """One case on this rank: {"ms", "result"}."""
    import torch.distributed as dist

    from nnstreamer_tpu_torch.parallel.launch import rank_device

    dev = rank_device()
    rank, world = dist.get_rank(), dist.get_world_size()
    g = torch.Generator().manual_seed(100 + rank)
    xf = torch.randn(N, generator=g).to(dev)
    xi = torch.randint(-1000, 1000, (N,), generator=g, dtype=torch.int32).to(dev)
    nxt, prv = (rank + 1) % world, (rank - 1) % world

    def all_reduce(x, op):
        def f():
            y = x.clone()
            dist.all_reduce(y, op=op)
            return y
        return f

    def broadcast():
        y = xf.clone()
        dist.broadcast(y, 0)
        return y

    def all_gather():
        out = [torch.empty_like(xf) for _ in range(world)]
        dist.all_gather(out, xf)
        return torch.stack(out)

    def all_gather_into_tensor():
        out = torch.empty(world * N, dtype=xf.dtype, device=dev)
        dist.all_gather_into_tensor(out, xf)
        return out

    def a2a_equal():
        out = torch.empty_like(xf)
        dist.all_to_all_single(out, xf)
        return out

    def a2a_rotate():
        out = torch.zeros_like(xf)
        ins = [N if j == nxt else 0 for j in range(world)]
        outs = [N if j == prv else 0 for j in range(world)]
        dist.all_to_all_single(out, xf, output_split_sizes=outs,
                               input_split_sizes=ins)
        return out

    def send_recv():
        out = torch.zeros_like(xf)
        if rank % 2 == 0:
            dist.send(xf, nxt)
            dist.recv(out, prv)
        else:
            dist.recv(out, prv)
            dist.send(xf, nxt)
        return out

    cases = {
        "all_reduce_sum_float32": all_reduce(xf, dist.ReduceOp.SUM),
        "all_reduce_max_float32": all_reduce(xf, dist.ReduceOp.MAX),
        "all_reduce_sum_int32": all_reduce(xi, dist.ReduceOp.SUM),
        "all_reduce_max_int32": all_reduce(xi, dist.ReduceOp.MAX),
        "broadcast": broadcast,
        "all_gather": all_gather,
        "all_gather_into_tensor": all_gather_into_tensor,
        "all_to_all_single_equal": a2a_equal,
        "all_to_all_single_rotation": a2a_rotate,
        "send_recv": send_recv,
    }
    fn = cases[name]
    res = fn()
    if res.device != dev:
        raise RuntimeError(f"result came back on {res.device}")
    return {"ms": _time(fn), "result": res.cpu().numpy()}


#: the cases, each run in a rank group of its own: gloo aborts the process
#: (it does not raise) on some calls with a CUDA tensor
CASES = ("all_reduce_sum_float32", "all_reduce_max_float32",
         "all_reduce_sum_int32", "all_reduce_max_int32", "broadcast",
         "all_gather", "all_gather_into_tensor", "all_to_all_single_equal",
         "all_to_all_single_rotation", "send_recv")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--cases", default=",".join(CASES),
                    help="comma-separated cases (default: all)")
    args = ap.parse_args()
    if args.device != "cpu" and not torch.cuda.is_available():
        print("probe_torch_dist: no CUDA device", file=sys.stderr)
        return 1
    from nnstreamer_tpu_torch.parallel.launch import RankGroup

    card = "cpu"
    if args.device != "cpu":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0]
        print(card, flush=True)
    findings = {"card": card, "world": args.world, "backend": "gloo",
                "device": args.device, "cases": {}}
    for name in args.cases.split(","):
        try:
            with RankGroup(args.world, device=args.device, timeout=30.0,
                           backend="gloo", quiet=True) as g:
                rs = g.run(probe_rank, name, wait=120.0)
            ok, error = True, None
        except (RuntimeError, TimeoutError) as e:  # a refusal is the finding
            rs, ok = [], False
            error = f"{type(e).__name__}: {str(e).strip().splitlines()[-1][:300]}"
        equal = None
        if ok and name.startswith(("all_reduce", "broadcast", "all_gather")):
            equal = all(np.array_equal(rs[0]["result"], r["result"]) for r in rs)
        ms = max(r["ms"] for r in rs) if ok else None
        findings["cases"][name] = {"ok": ok, "error": error,
                                   "ms_max_over_ranks": ms,
                                   "ranks_bit_equal": equal}
        print(f"{name}: {'takes' if ok else 'refuses'} {args.device} tensors"
              + (f", {ms:.4f} ms a call (slowest rank)" if ok else "")
              + (f", ranks bit-equal: {equal}" if equal is not None else "")
              + ("" if ok else f" — {error}"), flush=True)
    print(json.dumps(findings), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
