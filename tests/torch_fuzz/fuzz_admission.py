"""Fuzz target: the admission subsystem's structural invariants.

(A port-owned copy of the reference package's ``fuzz/fuzz_admission.py``,
driving ``cpzk_tpu_torch``.)

Arbitrary bytes drive a schedule of admission decisions — hostile client
keys, garbage RPC names, adversarial clock jumps — against a controller
with byte-derived settings.  Invariants:

- the keyed-bucket table NEVER exceeds its LRU bound, no matter how many
  distinct keys the input mints (the keyspace is not a memory-DoS
  primitive);
- ``classify`` is total: any input maps to a known tier, never raises;
- ``AdmissionController.admit`` never raises on arbitrary rpc/key input;
  a rejection always carries a pushback inside the configured
  ``[retry_after_min_ms, retry_after_max_ms]`` bounds and a known reason;
- the admission level stays inside ``[MIN_LEVEL, N_TIERS]`` under any
  signal sequence, and the priority ordering is structural: whenever a
  tier is admitted, every higher-priority (lower-numbered) tier is too.

Run: python tests/torch_fuzz/fuzz_admission.py [--seconds 15] [--seed 0]
"""

from __future__ import annotations

from common import run_fuzzer

from cpzk_tpu_torch.admission import (
    MIN_LEVEL,
    N_TIERS,
    AdmissionController,
    classify,
)
from cpzk_tpu_torch.server.config import AdmissionSettings


def _seeds() -> list[bytes]:
    return [
        b"\x08\x04" + b"client-a" * 4 + b"\xff" * 8,
        bytes(range(64)),
        b"VerifyProofRegisterCreateChallenge" + b"\x00\x01\x02\x03",
    ]


_RPCS = ["VerifyProof", "CreateChallenge", "Register", "RegisterBatch",
         "VerifyProofBatch", "", "Bogus", None]


def one_input(data: bytes) -> None:
    if len(data) < 4:
        data = data + b"\x00" * 4
    max_clients = 1 + data[0] % 32
    settings = AdmissionSettings(
        per_client_rpm=(data[1] % 4) * 30,  # includes 0 = disabled
        per_client_burst=1 + data[2] % 8,
        max_clients=max_clients,
        adjust_interval_ms=1.0 + data[3],
        increase_step=0.5,
        decrease_factor=0.5,
    )
    now = [0.0]
    sig = [0.0, 0.0]
    controller = AdmissionController(
        settings, clock=lambda: now[0], signals=lambda: (sig[0], sig[1])
    )
    lo = settings.retry_after_min_ms / 1000.0
    hi = settings.retry_after_max_ms / 1000.0

    for i in range(0, len(data) - 2, 3):
        op, a, b = data[i], data[i + 1], data[i + 2]
        now[0] += (op % 16) * 0.05
        sig[0] = a / 255.0  # utilization sweep: healthy <-> overloaded
        sig[1] = (b / 255.0) * 0.2
        rpc = _RPCS[a % len(_RPCS)]
        if op % 5 == 0:
            rpc = data[i: i + 8].decode("latin-1")  # arbitrary rpc name
        key = data[b % max(1, len(data)):][:16].decode("latin-1") or "k"

        tier = classify(rpc)
        assert tier in (0, 1, 2)

        rejection = controller.admit(rpc, key)
        assert len(controller.buckets) <= max_clients
        assert MIN_LEVEL <= controller.level <= float(N_TIERS)
        if rejection is not None:
            assert rejection.reason in ("per_client", "priority")
            assert lo <= rejection.retry_after_s <= hi
            assert isinstance(rejection.message, str) and rejection.message
            if rejection.reason == "priority":
                # ordering is structural: only tiers at/above the level
                # are shed, and the MIN_LEVEL floor exempts tier 0
                # (VerifyProof) from priority shedding entirely
                assert rejection.tier >= controller.level
                assert rejection.tier > 0


if __name__ == "__main__":
    run_fuzzer(one_input, _seeds())
