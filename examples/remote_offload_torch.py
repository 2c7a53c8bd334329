"""Remote offload demo on the port: a client pipeline sends frames to a
server pipeline over TCP (both ends in one process for the demo; they can
be separate hosts). Both ends use async_depth so round trips overlap
instead of serializing (set both to 1 for the reference's strict
synchronous per-buffer semantics). The server's filter runs on the card.

    python examples/remote_offload_torch.py [--device cuda|cpu]

Without a card the default device raises; there is no fallback.
"""

import _bootstrap  # noqa: F401  (repo-root import shim for source checkouts)

import argparse
import time
from typing import Any, List, Optional

import numpy as np

SPEC = "zoo://mobilenet_v2?width=0.25&size=64&num_classes=10&dtype=float32"


def frames() -> List[np.ndarray]:
    """The client's ten frames, as the JAX example draws them."""
    rng = np.random.default_rng(0)
    return [rng.integers(0, 255, (1, 64, 64, 3)).astype(np.uint8)
            for _ in range(10)]


def offload(model: Any = None, device: Any = "cuda") -> List[np.ndarray]:
    """Serve ``model`` (default: the zoo's ``SPEC``) behind the query hop;
    returns the logits of every frame as the client received them."""
    from nnstreamer_tpu_torch.core import Caps, TensorsConfig, TensorsInfo
    from nnstreamer_tpu_torch.core.hw import resolve_device
    from nnstreamer_tpu_torch.graph import Pipeline

    dev = resolve_device(device)
    server = Pipeline("server", device=dev)
    ssrc = server.add_new("tensor_query_serversrc", port=0, id=0,
                          dims="3:64:64:1", types="uint8")
    filt = server.add_new("tensor_filter",
                          model=SPEC if model is None else model)
    ssink = server.add_new("tensor_query_serversink", id=0, async_depth=16)
    Pipeline.link(ssrc, filt, ssink)
    server.start()
    time.sleep(0.3)
    port = ssrc.bound_port
    print(f"server listening on :{port}")

    client = Pipeline("client", device=dev)
    src = client.add_new(
        "appsrc",
        caps=Caps.tensors(TensorsConfig(
            TensorsInfo.from_strings("3:64:64:1", "uint8"), 30)),
        data=frames())
    qc = client.add_new("tensor_query_client", port=port, async_depth=16)
    logits = []

    def on_frame(b) -> None:
        out = np.asarray(b.memories[0].host())
        logits.append(out)
        print(f"frame {b.offset}: logits {out[0, :3]}...")

    sink = client.add_new("tensor_sink", new_data=on_frame)
    Pipeline.link(src, qc, sink)
    try:
        client.run(timeout=300)
    finally:
        server.stop()
    return logits


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    offload(device=args.device)


if __name__ == "__main__":
    main()
