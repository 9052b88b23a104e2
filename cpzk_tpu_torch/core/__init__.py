"""Host-plane cryptographic core (pure Python).

Integer-exact implementations of the ristretto255 group (RFC 9496), the
scalar ring mod ℓ, Keccak-f[1600]/STROBE-128 transcripts, and the OS CSPRNG
wrapper.  These are the oracles the GPU data plane (``cpzk_tpu_torch.ops``)
is tested against, and the trusted path for single-proof operations.  There
is no native host core in this package: every operation runs in Python.
"""
