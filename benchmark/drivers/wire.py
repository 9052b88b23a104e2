"""The few protobuf messages of ``proto/auth.proto`` the login clients send
and read, encoded and decoded by hand (proto3: varints and length-delimited
fields only), so that the clients share no code with the program."""

from __future__ import annotations

SERVICE = "/auth.AuthService/"


def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field(number: int, payload: bytes) -> bytes:
    return _varint(number << 3 | 2) + _varint(len(payload)) + payload


def fields(data: bytes):
    """(field number, value) of each field: an int for a varint, bytes for
    a length-delimited field."""
    i, n = 0, len(data)
    while i < n:
        key, shift = 0, 0
        while True:
            b = data[i]
            i += 1
            key |= (b & 0x7F) << shift
            shift += 7
            if not b & 0x80:
                break
        number, kind = key >> 3, key & 7
        if kind == 0:
            v, shift = 0, 0
            while True:
                b = data[i]
                i += 1
                v |= (b & 0x7F) << shift
                shift += 7
                if not b & 0x80:
                    break
            yield number, v
        elif kind == 2:
            ln, shift = 0, 0
            while True:
                b = data[i]
                i += 1
                ln |= (b & 0x7F) << shift
                shift += 7
                if not b & 0x80:
                    break
            yield number, data[i:i + ln]
            i += ln
        elif kind == 1:
            yield number, data[i:i + 8]
            i += 8
        elif kind == 5:
            yield number, data[i:i + 4]
            i += 4
        else:
            raise ValueError(f"protobuf wire type {kind} not handled")


def challenge_request(user_id: str) -> bytes:
    return _field(1, user_id.encode())


def challenge_id(response: bytes) -> bytes:
    for number, value in fields(response):
        if number == 1:
            return bytes(value)
    return b""


def batch_register_request(user_ids, y1s, y2s) -> bytes:
    return (b"".join(_field(1, u.encode()) for u in user_ids)
            + b"".join(_field(2, y) for y in y1s)
            + b"".join(_field(3, y) for y in y2s))


def batch_verify_request(user_ids, challenge_ids, proofs) -> bytes:
    return (b"".join(_field(1, u.encode()) for u in user_ids)
            + b"".join(_field(2, c) for c in challenge_ids)
            + b"".join(_field(3, p) for p in proofs))


def results(response: bytes) -> list[tuple[bool, str, str | None]]:
    """(success, message, session token or None) of each result of a
    ``BatchVerificationResponse`` or ``BatchRegistrationResponse``."""
    out = []
    for number, value in fields(response):
        if number != 1:
            continue
        ok, msg, token = False, "", None
        for n2, v2 in fields(value):
            if n2 == 1:
                ok = bool(v2)
            elif n2 == 2:
                msg = bytes(v2).decode()
            elif n2 == 3:
                token = bytes(v2).decode()
        out.append((ok, msg, token))
    return out
