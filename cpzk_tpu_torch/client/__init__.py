"""Client plane: gRPC auth client, password KDF, REPL CLI.

The port of ``cpzk_tpu/client/``; importing it needs no ``argon2``
(the KDF imports it when it runs).

Reference analog: ``src/bin/client.rs`` (SURVEY.md §2.1 #15). The KDF is
byte-compatible so statements registered by either implementation verify
against the other.
"""

from .kdf import password_to_scalar
from .rpc import AuthClient

__all__ = ["AuthClient", "password_to_scalar"]
