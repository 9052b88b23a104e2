"""Twins of ``tests/test_kdf.py`` for the port's KDF
(``cpzk_tpu_torch/client/kdf.py``), against the same pinned vectors.

The client's credential pipeline (``client/kdf.py``; reference
``src/bin/client.rs:179-204``) must never drift: statements are derived
from these scalars, so a silent change to the salt construction, the
Argon2id parameters (m=19456 KiB, t=2, p=1, v=0x13), the SHA-512 DST, or
the wide reduction would strand every registered credential.  The
vectors in ``tests/vectors/kdf_vectors.json`` were generated by the
reference's implementation and freeze the full pipeline; intermediate-stage checks
below localize a failure to the stage that drifted.
"""

import hashlib
import json
import os

import pytest

from cpzk_tpu_torch.client import kdf
from cpzk_tpu_torch.core.ristretto import Ristretto255

VEC_PATH = os.path.join(os.path.dirname(__file__), "vectors", "kdf_vectors.json")


def _vectors():
    with open(VEC_PATH, encoding="utf-8") as f:
        return json.load(f)["vectors"]


def test_kdf_vectors_pinned():
    vecs = _vectors()
    assert len(vecs) >= 5
    for v in vecs:
        s = kdf.password_to_scalar(v["password"], v["user_id"])
        assert Ristretto255.scalar_to_bytes(s).hex() == v["scalar_le_hex"], (
            f"KDF drift for user {v['user_id']!r} — Argon2id/salt/DST "
            "parameters no longer match the pinned pipeline"
        )


def test_kdf_parameter_constants():
    """The RustCrypto argon2 crate defaults the reference relies on."""
    assert kdf.ARGON2_MEMORY_KIB == 19456
    assert kdf.ARGON2_TIME_COST == 2
    assert kdf.ARGON2_PARALLELISM == 1
    assert kdf.ARGON2_HASH_LEN == 32
    assert kdf.SALT_PREFIX == "chaum-pedersen-v1.0.0-"
    assert kdf.SCALAR_DST == b"chaum-pedersen-zkp-scalar-derivation"


def test_kdf_salt_stage():
    """Salt = SHA-256(prefix || user)[0:16] (client.rs:181-183) — compared
    against the salt the KDF actually derives, so salt-stage drift
    (truncation length, prefix, encoding) fails HERE, not just in the
    end-to-end pinned vectors."""
    expected = hashlib.sha256(b"chaum-pedersen-v1.0.0-alice").digest()[:16]
    assert kdf.derive_salt("alice") == expected
    # distinct users -> distinct salts -> distinct scalars for same password
    assert kdf.derive_salt("alice") != kdf.derive_salt("bob")
    a = kdf.password_to_scalar("pw", "alice")
    b = kdf.password_to_scalar("pw", "bob")
    assert a != b


def test_kdf_deterministic_and_scalar_valid():
    s1 = kdf.password_to_scalar("pw", "alice")
    s2 = kdf.password_to_scalar("pw", "alice")
    assert s1 == s2
    # canonical scalar round-trip
    b = Ristretto255.scalar_to_bytes(s1)
    assert Ristretto255.scalar_from_bytes(b) == s1


def test_kdf_argon2_stage_pinned():
    """Isolate the Argon2id stage: a known (password, salt) -> okm.

    If test_kdf_vectors_pinned fails but this passes, the drift is in the
    salt/DST/reduction stages, not Argon2 itself (and vice versa).
    """
    okm = kdf._argon2id(b"probe", b"0123456789abcdef")
    assert okm.hex() == (
        _vectors_meta().get("argon2_probe")
        or pytest.skip("no argon2 probe recorded")
    )


def _vectors_meta():
    with open(VEC_PATH, encoding="utf-8") as f:
        return json.load(f)
