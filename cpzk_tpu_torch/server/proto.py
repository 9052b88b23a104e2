"""Protobuf message bindings for ``proto/auth.proto``,
``proto/health.proto`` and ``proto/replication.proto``.

The port's copy of ``cpzk_tpu/server/proto.py`` with one difference: the
message modules are committed under ``cpzk_tpu_torch/_gen/`` and imported
by their package-qualified names.  Nothing runs ``protoc`` and nothing goes
on ``sys.path`` at run time, so a process that loads both packages never
hands one package the other's top-level ``auth_pb2``.  The gRPC plumbing is
hand-wired from grpcio's generic handler API instead of a generated
``*_pb2_grpc`` module (see ``service.py`` and
``replication/wire.py``).
"""

from __future__ import annotations

SERVICE_NAME = "auth.AuthService"

_METHODS = {
    "Register": ("RegistrationRequest", "RegistrationResponse"),
    "RegisterBatch": ("BatchRegistrationRequest", "BatchRegistrationResponse"),
    "CreateChallenge": ("ChallengeRequest", "ChallengeResponse"),
    "VerifyProof": ("VerificationRequest", "VerificationResponse"),
    "VerifyProofBatch": ("BatchVerificationRequest", "BatchVerificationResponse"),
}

#: Bidirectional-streaming RPCs (wired via stream_stream handlers, kept
#: out of ``_METHODS`` so the unary handler loop stays unchanged).
_STREAM_METHODS = {
    "VerifyProofStream": ("StreamVerifyRequest", "StreamVerifyResponse"),
}


def load_pb2():
    """The ``auth_pb2`` message module."""
    from .._gen import auth_pb2

    return auth_pb2


def load_health_pb2():
    """The ``health_pb2`` message module (grpc.health.v1)."""
    from .._gen import health_pb2

    return health_pb2


def load_replication_pb2():
    """The ``replication_pb2`` message module (WAL segment shipping)."""
    from .._gen import replication_pb2

    return replication_pb2


def method_types(pb2):
    """{rpc name: (request class, response class)} for the unary RPCs."""
    return {
        name: (getattr(pb2, req), getattr(pb2, resp))
        for name, (req, resp) in _METHODS.items()
    }


def stream_method_types(pb2):
    """{rpc name: (request class, response class)} for the bidi-streaming
    RPCs (``VerifyProofStream``)."""
    return {
        name: (getattr(pb2, req), getattr(pb2, resp))
        for name, (req, resp) in _STREAM_METHODS.items()
    }
