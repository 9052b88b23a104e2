"""GPU data plane: batched GF(2^255-19) / ristretto255 operations on
limb-major ``[20, n]`` int32 tensors.

- :mod:`.limbs` / :mod:`.curve` — field and point operations
- :mod:`.point_kernels` — the CUDA point kernels (add, fused k-doubling)
  with their plain PyTorch versions and launch counters
- :mod:`.verify` — per-proof and combined verification ladders
- :mod:`.backend` — ``TorchBackend``, the ``VerifierBackend`` over them
"""
