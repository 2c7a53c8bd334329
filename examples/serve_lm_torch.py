"""Continuous-batching LM serving on the port: mixed decoding modes in one
engine on the card.

Submits greedy, sampled (temperature/top-k/nucleus), and EOS-bounded
requests to one `serving.LMEngine`; all streams multiplex into a single
batched decode step (captured as a CUDA graph on the card), and sampled
streams are reproducible (seeded; the JAX package's keys and draws)
regardless of what shares the batch. A second engine with `spec_draft`
shows prompt-lookup speculative decoding accepting multiple tokens per
dispatch on repetitive text with greedy output unchanged. A third serves
the w8a8 form of the same params: int8 GEMMs, with the MLP's int32
accumulator dequantized, GELU'd and requantized by the hand-written
`dequant_gelu_requant` kernel.

    python examples/serve_lm_torch.py [--device cuda|cpu]

``--cpu`` is a synonym of ``--device cpu``. Without a card the default
device raises; there is no fallback.
"""

import _bootstrap  # noqa: F401  (repo-root import shim for source checkouts)

import argparse
from typing import Any, Dict, List, Optional

import numpy as np

V, D, H, L, MAXLEN = 128, 64, 4, 2, 128


def serve(params: Any = None, device: Any = "cuda") -> Dict[str, List[int]]:
    """Serve the example's requests over ``params`` (a causal-LM tree of
    tensors; default: the port's seeded placeholder weights on
    ``device``); returns each request's tokens by name."""
    from nnstreamer_tpu_torch.core.hw import resolve_device
    from nnstreamer_tpu_torch.models import causal_lm
    from nnstreamer_tpu_torch.models.convert import causal_lm_params
    from nnstreamer_tpu_torch.serving import LMEngine

    dev = resolve_device(device)
    if params is None:
        params = causal_lm_params(
            causal_lm.init_causal_lm(0, V, D, H, L, MAXLEN), dev)

    eng = LMEngine(params, n_heads=H, max_len=MAXLEN, n_slots=4, chunk=8,
                   device=dev)
    rng = np.random.default_rng(0)
    rids = {
        "greedy": eng.submit(rng.integers(0, V, 12), max_new=16),
        "sampled t=1.0": eng.submit(
            rng.integers(0, V, 9), max_new=16, temperature=1.0, seed=7),
        "nucleus p=0.9": eng.submit(
            rng.integers(0, V, 5), max_new=16, temperature=1.2,
            top_p=0.9, seed=8),
        "top-k 16": eng.submit(
            rng.integers(0, V, 7), max_new=16, temperature=0.8,
            top_k=16, seed=9),
    }
    results = eng.run()
    out = {}
    for name, rid in rids.items():
        out[name] = results[rid]
        print(f"{name:14s} -> {results[rid]}")
    print("engine stats:", {k: v for k, v in eng.stats.items()
                            if not k.startswith("spec")})

    # live metrics: `from nnstreamer_tpu_torch.obs import start_exporter;
    # start_exporter(port=9464)` before running the engine exposes
    # TTFT/per-token latency histograms, slot occupancy, and per-bucket
    # prefill captures at http://127.0.0.1:9464/metrics (also available
    # as `nns-launch-torch --metrics-port`)

    # speculative decoding on repetitive text: greedy output unchanged,
    # multiple tokens accepted per dispatch
    rep = np.array([5, 9, 2, 7] * 4, np.int32)
    plain = LMEngine(params, n_heads=H, max_len=MAXLEN, n_slots=1, device=dev)
    spec = LMEngine(params, n_heads=H, max_len=MAXLEN, n_slots=1,
                    spec_draft=4, device=dev)
    a = plain.submit(rep, max_new=24)
    b = spec.submit(rep, max_new=24)
    out["plain"], out["speculative"] = plain.run()[a], spec.run()[b]
    assert out["plain"] == out["speculative"], "speculation changed output"
    st = spec.stats
    print(f"speculative: identical greedy output; "
          f"{st['spec_accepted']} drafts accepted over "
          f"{st['spec_iterations']} iterations "
          f"(acceptance {st['spec_accepted'] / max(1, st['spec_drafted']):.0%})")

    # w8a8 int8 serving: the same engine over a quantized param tree —
    # int8 GEMMs (ops/int8.py); greedy output tracks the float engine
    qparams = causal_lm.quantize_lm_params(params)
    q = LMEngine(qparams, n_heads=H, max_len=MAXLEN, n_slots=2, chunk=8,
                 device=dev)
    qrid = q.submit(rng.integers(0, V, 10), max_new=12)
    out["w8a8"] = q.run()[qrid]
    print("w8a8 int8  ->", out["w8a8"])
    return out


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--cpu", action="store_true", help="same as --device cpu")
    args = ap.parse_args(argv)
    serve(device="cpu" if args.cpu else args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
