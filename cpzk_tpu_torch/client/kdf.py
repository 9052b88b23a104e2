"""Password -> secret scalar derivation (client.rs:179-204 twin).

A copy of ``cpzk_tpu/client/kdf.py`` on the port's scalars.  ``argon2``
is imported only inside :func:`_argon2id`, so importing the client needs
no argon2 package (machines without it can still drive the service with
witnesses of their own).

Pipeline: salt = SHA-256("chaum-pedersen-v1.0.0-{user}")[0:16];
okm = Argon2id(password, salt) with the RustCrypto argon2 crate's default
parameters (m=19456 KiB, t=2, p=1, 32-byte output, version 0x13);
scalar = wide_reduce(SHA-512(okm || "chaum-pedersen-zkp-scalar-derivation")).
Parameters must not drift — interoperable statements depend on it
(SURVEY.md §2.2 argon2 row).
"""

from __future__ import annotations

import hashlib

from ..core.ristretto import Scalar
from ..core.scalars import sc_from_bytes_mod_order_wide

SALT_PREFIX = "chaum-pedersen-v1.0.0-"
SCALAR_DST = b"chaum-pedersen-zkp-scalar-derivation"

ARGON2_MEMORY_KIB = 19456
ARGON2_TIME_COST = 2
ARGON2_PARALLELISM = 1
ARGON2_HASH_LEN = 32


def _argon2id(password: bytes, salt: bytes) -> bytes:
    from argon2.low_level import Type, hash_secret_raw

    return hash_secret_raw(
        secret=password,
        salt=salt,
        time_cost=ARGON2_TIME_COST,
        memory_cost=ARGON2_MEMORY_KIB,
        parallelism=ARGON2_PARALLELISM,
        hash_len=ARGON2_HASH_LEN,
        type=Type.ID,
        version=19,
    )


def derive_salt(user_id: str) -> bytes:
    """Per-user Argon2 salt: SHA-256(prefix || user)[0:16] (client.rs:181-183)."""
    return hashlib.sha256((SALT_PREFIX + user_id).encode()).digest()[:16]


def password_to_scalar(password: str, user_id: str) -> Scalar:
    okm = _argon2id(password.encode(), derive_salt(user_id))
    digest = hashlib.sha512(okm + SCALAR_DST).digest()
    return Scalar(sc_from_bytes_mod_order_wide(digest))
