"""query-hybrid: broker-based server discovery; port of
nnstreamer_tpu/query/hybrid.py (the same line-JSON on the wire).

Reference: gst/nnstreamer/tensor_query/tensor_query_hybrid.c/.h (:25-110):
servers publish "<topic> → (host, port)" to an MQTT broker; clients subscribe
to get the node list and fail over between nodes.

The reference requires an external MQTT broker; to stay dependency-free this
ships a tiny built-in TCP name service (``DiscoveryBroker``) speaking
line-JSON, with the same register/discover contract. If paho-mqtt is present
an MQTT-backed implementation can be swapped in via the same functions.
"""

from __future__ import annotations

import json
import socket
import socketserver
import threading
from typing import Dict, List, Optional, Tuple

from ..graph.element import join_or_warn


class DiscoveryBroker:
    """Line-JSON TCP name service: {"op":"register","topic":t,"host":h,"port":p}
    / {"op":"unregister",...} / {"op":"discover","topic":t} → {"nodes":[[h,p]]}."""

    def __init__(self, host: str = "127.0.0.1", port: int = 5300):
        self._registry: Dict[str, List[Tuple[str, int]]] = {}
        self._lock = threading.Lock()
        broker = self

        class Handler(socketserver.StreamRequestHandler):
            def handle(self) -> None:
                for line in self.rfile:
                    try:
                        msg = json.loads(line)
                    except json.JSONDecodeError:
                        break
                    reply = broker._handle(msg)
                    self.wfile.write((json.dumps(reply) + "\n").encode())

        self._server = socketserver.ThreadingTCPServer((host, port), Handler,
                                                       bind_and_activate=False)
        self._server.allow_reuse_address = True
        self._server.server_bind()
        self._server.server_activate()
        self.host, self.port = self._server.server_address
        self._thread: Optional[threading.Thread] = None

    def _handle(self, msg: dict) -> dict:
        op = msg.get("op")
        topic = str(msg.get("topic", ""))
        with self._lock:
            if op == "register":
                node = (msg["host"], int(msg["port"]))
                self._registry.setdefault(topic, [])
                if node not in self._registry[topic]:
                    self._registry[topic].append(node)
                return {"ok": True}
            if op == "unregister":
                node = (msg["host"], int(msg["port"]))
                nodes = self._registry.get(topic, [])
                if node in nodes:
                    nodes.remove(node)
                return {"ok": True}
            if op == "discover":
                return {"ok": True,
                        "nodes": list(self._registry.get(topic, []))}
        return {"ok": False, "error": f"bad op {op!r}"}

    def start(self) -> "DiscoveryBroker":
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True, name="query-broker")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        # join between shutdown() and server_close(): serve_forever may
        # still be inside its poll when close() pulls the socket away,
        # and the leaked thread then outlives the broker object
        t = self._thread
        if t is not None and t is not threading.current_thread():
            join_or_warn(t, "query-broker", timeout=2.0)
        self._thread = None
        self._server.server_close()


def _rpc(host: str, port: int, msg: dict, timeout: float = 5.0) -> dict:
    with socket.create_connection((host, port), timeout=timeout) as sock:
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        sock.sendall((json.dumps(msg) + "\n").encode())
        data = sock.makefile().readline()
    return json.loads(data or "{}")


def register_node(topic: str, host: str, port: int,
                  broker_host: str = "127.0.0.1", broker_port: int = 5300) -> bool:
    return _rpc(broker_host, broker_port,
                {"op": "register", "topic": topic, "host": host,
                 "port": port}).get("ok", False)


def unregister_node(topic: str, host: str, port: int,
                    broker_host: str = "127.0.0.1", broker_port: int = 5300) -> bool:
    return _rpc(broker_host, broker_port,
                {"op": "unregister", "topic": topic, "host": host,
                 "port": port}).get("ok", False)


def discover(topic: str, broker_host: str = "127.0.0.1",
             broker_port: int = 5300) -> List[Tuple[str, int]]:
    nodes = _rpc(broker_host, broker_port,
                 {"op": "discover", "topic": topic}).get("nodes", [])
    return [(h, int(p)) for h, p in nodes]
