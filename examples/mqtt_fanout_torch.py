"""MQTT pub/sub stream fan-out on the port, over a real MQTT 3.1.1 broker.

One camera pipeline publishes tensors to a topic; two subscriber pipelines
(e.g. a recorder and a detector) each receive every frame. Works against
the built-in broker below or any standard broker (mosquitto/EMQX) — the
elements speak genuine MQTT 3.1.1 and the message payload carries the
reference-layout GstMQTTMessageHdr, so upstream nnstreamer peers and the
JAX package's pipelines can subscribe too.

Run: python examples/mqtt_fanout_torch.py [--device cuda|cpu]

Without a card the default device raises; there is no fallback.
"""

import _bootstrap  # noqa: F401  (repo-root import shim for source checkouts)

import argparse
import time
from typing import Any, List, Optional, Tuple

import numpy as np


def subscriber(name: str, port: int, topic: str, device: Any) -> tuple:
    from nnstreamer_tpu_torch.graph import Pipeline

    p = Pipeline(name, device=device)
    src = p.add_new("mqttsrc", port=port, sub_topic=topic)
    sink = p.add_new("tensor_sink", store=True)
    Pipeline.link(src, sink)
    p.start()
    return p, sink


def fanout(device: Any = "cuda") -> Tuple[int, int]:
    """Publish ten frames; returns how many each subscriber received."""
    from nnstreamer_tpu_torch.core import Caps, TensorsConfig, TensorsInfo
    from nnstreamer_tpu_torch.core.hw import resolve_device
    from nnstreamer_tpu_torch.graph import Pipeline
    from nnstreamer_tpu_torch.query.mqtt import MqttBroker

    dev = resolve_device(device)
    broker = MqttBroker(port=0).start()
    print(f"broker on 127.0.0.1:{broker.port}")

    rec_p, rec_sink = subscriber("recorder", broker.port, "cam/+", dev)
    det_p, det_sink = subscriber("detector", broker.port, "cam/0", dev)
    time.sleep(0.3)

    pub = Pipeline("camera", device=dev)
    caps = Caps.tensors(TensorsConfig(
        TensorsInfo.from_strings("3:32:32:1", "uint8"), 30))
    frames = [np.random.default_rng(i).integers(0, 255, (1, 32, 32, 3))
              .astype(np.uint8) for i in range(10)]
    src = pub.add_new("appsrc", caps=caps, data=frames)
    sink = pub.add_new("mqttsink", port=broker.port, pub_topic="cam/0")
    Pipeline.link(src, sink)
    pub.run(timeout=30)

    deadline = time.monotonic() + 10
    while (rec_sink.num_buffers < 10 or det_sink.num_buffers < 10) \
            and time.monotonic() < deadline:
        time.sleep(0.05)
    rec_p.stop()
    det_p.stop()
    broker.stop()
    print(f"recorder got {rec_sink.num_buffers}, detector got "
          f"{det_sink.num_buffers}")
    if rec_sink.buffers:
        lat = rec_sink.buffers[-1].meta["mqtt_latency_us"]
        print(f"last transit latency {lat} µs")
    return rec_sink.num_buffers, det_sink.num_buffers


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    fanout(device=args.device)


if __name__ == "__main__":
    main()
