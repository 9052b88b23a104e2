"""Fuzz target: statement/element decoding + validation

(A port-owned copy of the reference package's ``fuzz/fuzz_statement_validation.py``,
driving ``cpzk_tpu_torch``.)
(reference analog ``fuzz/fuzz_targets/fuzz_statement_validation.rs``;
decoder under test mirrors ``src/primitives/ristretto.rs:94-138`` and
``gadgets.rs:217-238``).

Invariants:
- ``element_from_bytes`` / ``scalar_from_bytes`` either succeed or raise
  ``cpzk_tpu_torch.Error`` — never another exception;
- a decoded element re-encodes to the same 32 bytes (canonical encoding);
- ``Statement.validate`` never crashes on decodable input pairs.

Run: python tests/torch_fuzz/fuzz_statement_validation.py [--seconds 15] [--seed 0]
"""

from __future__ import annotations

from common import run_fuzzer

from cpzk_tpu_torch import Error, Statement
from cpzk_tpu_torch.core.ristretto import Ristretto255


def _seeds() -> list[bytes]:
    g = Ristretto255.generator_g()
    h = Ristretto255.generator_h()
    gb = Ristretto255.element_to_bytes(g)
    hb = Ristretto255.element_to_bytes(h)
    return [gb + hb, gb + gb, bytes(32) + hb, gb, hb + bytes(64)]


def one_input(data: bytes) -> None:
    half = len(data) // 2
    y1b, y2b = data[:half], data[half:]
    try:
        y1 = Ristretto255.element_from_bytes(y1b)
    except Error:
        return
    # canonical re-encode invariant on the accepted element
    assert Ristretto255.element_to_bytes(y1) == bytes(y1b), "non-canonical element"
    try:
        y2 = Ristretto255.element_from_bytes(y2b)
    except Error:
        return
    try:
        Statement(y1, y2).validate()
    except Error:
        return

    # scalar path on the same raw bytes
    try:
        s = Ristretto255.scalar_from_bytes(y1b)
    except Error:
        return
    assert Ristretto255.scalar_to_bytes(s) == bytes(y1b), "non-canonical scalar"


if __name__ == "__main__":
    run_fuzzer(one_input, _seeds())
