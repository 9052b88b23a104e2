"""Shared error taxonomy.

Mirrors the reference's three-variant error enum (``src/error.rs:4-17``):
``InvalidParams``, ``InvalidScalar``, ``InvalidGroupElement`` (and
``InvalidProofEncoding``, its deferred-parse form), plus the two errors of
the state store (``UnsupportedFormat``, ``WrongPartition``).  Class names
and messages are those of ``cpzk_tpu.errors``: accept/reject parity between
the two packages includes the error text.
"""


class Error(Exception):
    """Base class for all protocol errors."""


class InvalidParams(Error):
    """Invalid protocol parameters (reference ``Error::InvalidParams``)."""


class InvalidScalar(Error):
    """Invalid scalar encoding/value (reference ``Error::InvalidScalar``)."""


class InvalidGroupElement(Error):
    """Invalid group element encoding/value (reference ``Error::InvalidGroupElement``)."""


class InvalidProofEncoding(InvalidGroupElement):
    """A deferred-parse proof whose commitment wire failed to decode at the
    batch-verify stage.  Same taxonomy slot as the eager parse error
    (``InvalidGroupElement`` from ``element_from_bytes``), and the same
    message, so deferred parsing is observationally identical to eager
    parsing."""


class UnsupportedFormat(Error):
    """A persisted artifact (a state snapshot) carries a format stamp newer
    than this build writes, or an unintelligible one.  Not a quarantine
    case: the file is not corrupt, the binary is old, so restore refuses
    it, naming both versions."""


class WrongPartition(Error):
    """A user-keyed mutation reached a partition that no longer owns the
    user.  Raised by :class:`~cpzk_tpu_torch.server.state.ServerState`'s
    write-time ownership fence (``owner_fence``, ``None`` until a fleet
    attaches one); the service answers it with the ``FAILED_PRECONDITION``
    redirect of its entry check."""
