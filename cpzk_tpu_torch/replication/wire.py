"""gRPC plumbing for the replication plane (hand-wired like auth).

The message module is the committed ``cpzk_tpu_torch._gen.replication_pb2``
(via :mod:`cpzk_tpu_torch.server.proto`), and the service is wired through
grpcio's generic handler API on the server side and raw
``channel.unary_unary`` multicallables on the client side, as the
reference's is.
"""

from __future__ import annotations

import grpc

from ..server.proto import load_replication_pb2

SERVICE_NAME = "replication.ReplicationService"

_METHODS = {
    "ShipSegment": ("ShipSegmentRequest", "ShipSegmentResponse"),
    "ReplicationStatus": (
        "ReplicationStatusRequest", "ReplicationStatusResponse",
    ),
    "Handover": ("HandoverRequest", "HandoverResponse"),
}


def method_types(pb2):
    """{rpc name: (request class, response class)} for the three RPCs."""
    return {
        name: (getattr(pb2, req), getattr(pb2, resp))
        for name, (req, resp) in _METHODS.items()
    }


def make_replication_handler(impl) -> grpc.GenericRpcHandler:
    """Generic handler for an object with ``ship_segment``,
    ``replication_status``, and ``handover`` async methods — the
    :class:`StandbyReplica`, or the
    :class:`SegmentShipper`, which answers ship/status with refusals but
    serves ``Handover`` (phase "initiate") for the planned-operations
    plane."""
    pb2 = load_replication_pb2()
    types = method_types(pb2)
    methods = {
        "ShipSegment": impl.ship_segment,
        "ReplicationStatus": impl.replication_status,
        "Handover": impl.handover,
    }
    handlers = {
        name: grpc.unary_unary_rpc_method_handler(
            methods[name],
            request_deserializer=types[name][0].FromString,
            response_serializer=types[name][1].SerializeToString,
        )
        for name in methods
    }
    return grpc.method_handlers_generic_handler(SERVICE_NAME, handlers)


class ReplicationStub:
    """Client-side multicallables over an ``grpc.aio`` channel (the
    shipper's view of the standby)."""

    def __init__(self, channel: grpc.aio.Channel):
        pb2 = load_replication_pb2()
        self.pb2 = pb2
        types = method_types(pb2)
        self.ship_segment = channel.unary_unary(
            f"/{SERVICE_NAME}/ShipSegment",
            request_serializer=types["ShipSegment"][0].SerializeToString,
            response_deserializer=types["ShipSegment"][1].FromString,
        )
        self.replication_status = channel.unary_unary(
            f"/{SERVICE_NAME}/ReplicationStatus",
            request_serializer=types["ReplicationStatus"][0].SerializeToString,
            response_deserializer=types["ReplicationStatus"][1].FromString,
        )
        self.handover = channel.unary_unary(
            f"/{SERVICE_NAME}/Handover",
            request_serializer=types["Handover"][0].SerializeToString,
            response_deserializer=types["Handover"][1].FromString,
        )
