"""Schnorr-signed audit reports over the port's Ristretto + Merlin core.

A copy of ``cpzk_tpu/audit/sign.py``: the same scheme, domains and
deterministic nonce, so a key file minted by either package signs the
same report to the same bytes in the other.

The audit pipeline's output must be tamper-evident offline: a report
consumer who never saw the proof log can check that (a) the report body
was not altered after signing and (b) it was signed by the holder of the
audit key.  Standard Schnorr over ristretto255 with a Merlin transcript
as the Fiat-Shamir hash — entirely built from the primitives the proof
system already ships (:class:`~cpzk_tpu_torch.core.ristretto.Ristretto255`,
:class:`~cpzk_tpu_torch.core.transcript.MerlinTranscript`), no new crypto
dependencies:

    sign(x, m):  k = H_nonce(x, m)        (deterministic, RFC6979-style)
                 R = k*G
                 c = H_sig(m, P, R)       (Merlin transcript challenge)
                 s = k + c*x  (mod l)
                 signature = (R, s)
    verify:      s*G == R + c*P

The deterministic nonce makes signing a pure function of (key, message):
an audit run that resumes after SIGKILL reproduces the byte-exact report,
signature included — the resume-equivalence property the pipeline tests
pin.  ``message`` here is the report's transcript digest (the running
SHA-256 chain over every audited frame), so flipping a single byte of the
log or the report body changes ``m`` and the signature check fails.
"""

from __future__ import annotations

import hashlib
import json
import os

from ..core.ristretto import Element, Ristretto255, Scalar
from ..core.scalars import L, sc_from_bytes_mod_order_wide
from ..core.transcript import MerlinTranscript
from ..errors import Error

SIGN_DOMAIN = b"cpzk-audit-report/1"
NONCE_DOMAIN = b"cpzk-audit-nonce/1"


def generate_key(rng=None) -> Scalar:
    """A fresh audit signing scalar (CSPRNG unless ``rng`` is injected)."""
    if rng is None:
        from ..core.rng import SecureRng

        rng = SecureRng()
    return Ristretto255.random_scalar(rng)


def public_key(key: Scalar) -> bytes:
    """Wire encoding of ``key * G``."""
    return Ristretto255.element_to_bytes(
        Ristretto255.scalar_mul(Ristretto255.generator_g(), key)
    )


def load_or_create_key(path: str) -> Scalar:
    """The 64-hex signing scalar at ``path``, minted (0600) when absent."""
    if os.path.exists(path):
        with open(path, encoding="utf-8") as f:
            text = f.read().strip()
        try:
            raw = bytes.fromhex(text)
        except ValueError:
            raise ValueError(f"audit key file {path} is not hex") from None
        if len(raw) != 32:
            raise ValueError(
                f"audit key file {path} must hold 32 hex-encoded bytes"
            )
        return Ristretto255.scalar_from_bytes(raw)
    key = generate_key()
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_EXCL, 0o600)
    try:
        os.write(fd, Ristretto255.scalar_to_bytes(key).hex().encode())
    finally:
        os.close(fd)
    return key


def _challenge(message: bytes, pub: bytes, r_bytes: bytes) -> Scalar:
    t = MerlinTranscript(SIGN_DOMAIN)
    t.append_message(b"message", message)
    t.append_message(b"pubkey", pub)
    t.append_message(b"nonce-commitment", r_bytes)
    return Scalar(
        sc_from_bytes_mod_order_wide(t.challenge_bytes(b"challenge", 64))
    )


def _nonce(key: Scalar, message: bytes) -> Scalar:
    """Deterministic per-(key, message) nonce: never reused across
    messages, never random (resume-equivalence needs sign() pure)."""
    t = MerlinTranscript(NONCE_DOMAIN)
    t.append_message(b"key", Ristretto255.scalar_to_bytes(key))
    t.append_message(b"message", message)
    k = Scalar(
        sc_from_bytes_mod_order_wide(t.challenge_bytes(b"nonce", 64))
    )
    if k.value == 0:  # pragma: no cover - probability 1/l
        k = Scalar(1)
    return k


def sign(key: Scalar, message: bytes) -> tuple[bytes, bytes]:
    """``(R_bytes, s_bytes)`` Schnorr signature on ``message``."""
    k = _nonce(key, message)
    r_bytes = Ristretto255.element_to_bytes(
        Ristretto255.scalar_mul(Ristretto255.generator_g(), k)
    )
    c = _challenge(message, public_key(key), r_bytes)
    s = Scalar((k.value + c.value * key.value) % L)
    return r_bytes, Ristretto255.scalar_to_bytes(s)


def verify(pub: bytes, message: bytes, r_bytes: bytes, s_bytes: bytes) -> bool:
    """Offline signature check; False on any malformed input (total —
    the verify-report CLI must answer, not crash, on a tampered file)."""
    try:
        p = Ristretto255.element_from_bytes(pub)
        r = Ristretto255.element_from_bytes(r_bytes)
        if len(s_bytes) != 32:
            return False
        s = Ristretto255.scalar_from_bytes(s_bytes)
    except (Error, ValueError, TypeError):
        return False
    c = _challenge(message, pub, r_bytes)
    lhs = Ristretto255.scalar_mul(Ristretto255.generator_g(), s)
    rhs = Ristretto255.element_mul(r, Ristretto255.scalar_mul(p, c))
    return _eq(lhs, rhs)


def _eq(a: Element, b: Element) -> bool:
    return Ristretto255.element_to_bytes(a) == Ristretto255.element_to_bytes(b)


# -- report body canonicalization ------------------------------------------


def report_message(body: dict) -> bytes:
    """The signed message for a report body: SHA-256 over the canonical
    (compact, key-sorted) JSON encoding of every field EXCEPT the
    signature block itself."""
    scrubbed = {k: v for k, v in body.items() if k != "signature"}
    canon = json.dumps(
        scrubbed, separators=(",", ":"), sort_keys=True
    ).encode()
    return hashlib.sha256(canon).digest()


def sign_report(body: dict, key: Scalar) -> dict:
    """Attach a ``signature`` block to a report body (returns ``body``)."""
    message = report_message(body)
    r_bytes, s_bytes = sign(key, message)
    body["signature"] = {
        "scheme": "schnorr-ristretto255-merlin/1",
        "public_key": public_key(key).hex(),
        "r": r_bytes.hex(),
        "s": s_bytes.hex(),
    }
    return body


def verify_report(body: dict) -> tuple[bool, str]:
    """``(ok, reason)`` for a signed report dict — signature over the
    canonical body, plus the internal totals-consistency checks a
    flipped byte anywhere in the body would break."""
    sig = body.get("signature")
    if not isinstance(sig, dict):
        return False, "missing signature block"
    if sig.get("scheme") != "schnorr-ristretto255-merlin/1":
        return False, f"unknown signature scheme: {sig.get('scheme')!r}"
    try:
        pub = bytes.fromhex(sig["public_key"])
        r_bytes = bytes.fromhex(sig["r"])
        s_bytes = bytes.fromhex(sig["s"])
    except (KeyError, ValueError, TypeError):
        return False, "malformed signature fields"
    message = report_message(body)
    if not verify(pub, message, r_bytes, s_bytes):
        return False, "signature check failed"
    totals = body.get("totals", {})
    try:
        audited = int(totals["audited"])
        parts = (
            int(totals["verified"]) + int(totals["rejected"])
        )
        if audited != parts:
            return False, "totals inconsistent: audited != verified+rejected"
        if int(totals["records"]) != audited + int(totals["skipped"]):
            return False, "totals inconsistent: records != audited+skipped"
    except (KeyError, ValueError, TypeError):
        return False, "malformed totals block"
    return True, "ok"
