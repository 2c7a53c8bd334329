"""Distributed query/offload layer — port of nnstreamer_tpu/query/: wire
protocol, client/server elements, router, hybrid broker discovery, MQTT
and gRPC transports."""

from .protocol import Cmd, pack_message, recv_message, send_message
from .hybrid import DiscoveryBroker, discover, register_node, unregister_node

__all__ = ["Cmd", "pack_message", "recv_message", "send_message",
           "DiscoveryBroker", "discover", "register_node", "unregister_node"]
