"""chip_smoke.py's parallel phase (``run_parallel``) alone on the card.

    python3 scripts/profile_torch_parallel.py [N_REQUESTS]

Builds the CUDA kernels, then runs ``chip_smoke.run_parallel`` with the
serving mix cut to its first N_REQUESTS requests (default 24, the whole
mix): TP serving over 2 and 4 gloo ranks and 1 NCCL rank, the
sequence-parallel prefill, TP prefill+generate and dryrun_multichip's
lanes, every check as in the whole script. Run it from the root of the
tree; exits non-zero without a card.
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402

if __name__ == "__main__":
    import torch

    if not torch.cuda.is_available():
        print("profile_torch_parallel: no CUDA device", file=sys.stderr)
        sys.exit(1)
    from nnstreamer_tpu_torch.ops.kernels import build
    from nnstreamer_tpu_torch.ops.kernels import epilogue as ep
    from nnstreamer_tpu_torch.ops.kernels import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    build.build_all()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    cs.LM_REQUESTS = int(sys.argv[1]) if len(sys.argv) > 1 else cs.LM_REQUESTS
    counters = cs._Counters({"flash_attention": fa.flash_attention,
                             "dequant_gelu_requant": ep.dequant_gelu_requant})
    print(cs.run_parallel(counters), flush=True)
    print(f"total {time.perf_counter() - t0:.1f} s", flush=True)
