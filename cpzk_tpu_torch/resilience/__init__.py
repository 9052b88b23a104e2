"""Resilience: self-healing failover and fault injection.

- :mod:`.breaker` — a thread-safe circuit breaker with half-open probe
  recovery.  :class:`~cpzk_tpu_torch.protocol.batch.FailoverBackend`
  drives it, so a card failure degrades to the host fallback and then
  heals (a probe batch re-validated against the fallback's ground truth).
- :mod:`.faults` — a seeded, deterministic :class:`FaultPlan` and a
  backend injector, so the failure paths are exercised by the tests.

``faults`` pulls in :mod:`cpzk_tpu_torch.protocol.batch`, which itself
builds breakers, so this package eagerly exports only the breaker and
resolves the rest on attribute access.  The client retry policy of the
reference's ``resilience/`` comes with the port's client.
"""

from __future__ import annotations

from .breaker import BreakerState, CircuitBreaker

__all__ = [
    "BreakerState",
    "CircuitBreaker",
    "FaultInjectionBackend",
    "FaultPlan",
    "InjectedFault",
]


def __getattr__(name: str):
    if name in ("FaultInjectionBackend", "FaultPlan", "InjectedFault"):
        from . import faults

        return getattr(faults, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
