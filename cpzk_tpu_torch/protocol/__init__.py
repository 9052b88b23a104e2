"""Protocol layer: gadgets, prover, verifier, batch verification.

Reference parity: ``src/primitives/gadgets.rs``, ``src/prover/mod.rs``,
``src/verifier/mod.rs``, ``src/verifier/batch.rs``.
"""
