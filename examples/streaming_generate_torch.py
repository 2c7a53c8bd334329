"""Autoregressive generation as a streaming pipeline loop, on the port.

The KV cache rides the tensor_repo loop as device-resident stream
tensors (``torch.Tensor``s on the card); each loop iteration decodes ONE
token in O(1) work against the preallocated cache (no prefix recompute).
Greedy feedback happens in the app: the sink's logits pick the next token
pushed into appsrc.

    python examples/streaming_generate_torch.py [--tokens 24] [--device cuda|cpu]

``--cpu`` is a synonym of ``--device cpu``. Without a card the default
device raises; there is no fallback.
"""

import _bootstrap  # noqa: F401  (repo-root import shim for source checkouts)

import argparse
import sys
from typing import Any, List, Optional

import numpy as np

SPEC = "zoo://causal_lm?vocab=64&dim=64&heads=4&layers=2&max_len=64"


def generate(bundle: Any = None, prompt: Optional[List[int]] = None,
             tokens: int = 24, device: Any = "cuda") -> List[int]:
    """Teacher-force ``prompt`` then generate ``tokens`` greedily through
    the repo loop; ``bundle`` defaults to the zoo's ``SPEC``. Returns the
    generated tokens."""
    from nnstreamer_tpu_torch.core import Caps
    from nnstreamer_tpu_torch.core.hw import resolve_device
    from nnstreamer_tpu_torch.core.types import TensorsConfig, TensorsInfo
    from nnstreamer_tpu_torch.elements.repo import reset_repo
    from nnstreamer_tpu_torch.graph import Pipeline
    from nnstreamer_tpu_torch.models.zoo import get_model

    dev = resolve_device(device)
    prompt = list([1, 7, 3] if prompt is None else prompt)
    if bundle is None:
        bundle = get_model(SPEC, device=dev)
    meta = bundle.metadata
    flat = meta["layers"] * meta["batch"] * meta["heads"]
    hd, M = meta["head_dim"], meta["max_len"]
    if not prompt:
        raise ValueError("--prompt needs at least one token id")
    if len(prompt) + tokens > M:
        raise ValueError(f"prompt+tokens exceeds the model's max_len={M} cache")

    reset_repo()
    p = Pipeline("generate", device=dev)
    src = p.add_new("appsrc", caps=Caps.tensors(TensorsConfig(
        TensorsInfo.from_strings("1:1", "int32"), 0)))
    state = p.add_new("tensor_reposrc", slot_index=7,
                      dims=f"{hd}:{M}:{flat},{hd}:{M}:{flat},1",
                      types="float32,float32,int32")
    mux = p.add_new("tensor_mux", sync_mode="nosync")
    filt = p.add_new("tensor_filter", framework="torch-cuda", model=bundle)
    demux = p.add_new("tensor_demux", tensorpick="0,1:2:3")
    q_out, q_state = p.add_new("queue"), p.add_new("queue")
    rsink = p.add_new("tensor_reposink", slot_index=7)
    sink = p.add_new("tensor_sink")

    generated: List[int] = []
    feed = list(prompt)

    def on_logits(buf) -> None:
        logits = buf.memories[0].host()[0]
        nxt = int(np.argmax(logits))
        if feed:  # still teacher-forcing the prompt
            tok = feed.pop(0)
        else:
            tok = nxt
            generated.append(tok)
        if len(generated) >= tokens:
            src.end_of_stream()
        else:
            src.push_buffer(np.array([[tok]], np.int32))

    sink.new_data = on_logits
    Pipeline.link(src, mux)
    Pipeline.link(state, mux)
    Pipeline.link(mux, filt, demux)
    Pipeline.link(demux, q_out, sink)
    Pipeline.link(demux, q_state, rsink)
    p.start()
    # pop BEFORE pushing: on_logits (sink thread) also pops this list, so
    # mutating after the push would race the first decode's callback
    first = feed.pop(0)
    src.push_buffer(np.array([[first]], np.int32))
    p.wait_eos(300)
    p.stop()
    print(f"prompt={prompt} generated={generated}")
    return generated


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tokens", type=int, default=24)
    ap.add_argument("--prompt", type=int, nargs="*", default=[1, 7, 3])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--cpu", action="store_true", help="same as --device cpu")
    args = ap.parse_args(argv)
    try:
        generate(prompt=args.prompt, tokens=args.tokens,
                 device="cpu" if args.cpu else args.device)
    except ValueError as e:
        ap.error(str(e))
    return 0


if __name__ == "__main__":
    sys.exit(main())
