"""GPU data plane: batched GF(2^255-19) / ristretto255 operations on
limb-major ``[20, n]`` int32 tensors.

- :mod:`.limbs` / :mod:`.curve` — field and point operations
- :mod:`.point_kernels` — the CUDA point kernels (add, fused k-doubling)
  with their plain PyTorch versions and launch counters
- :mod:`.sclimbs` — scalar arithmetic mod l on limb tensors; with
  :mod:`.scalar_kernels`, the CUDA kernels of the device scalar plane
  (RLC products and corrections, window and signed-digit recode)
- :mod:`.msm` — the signed-digit Pippenger MSM; its CUDA kernels (bucket
  sums, window reduction and Horner) are in :mod:`.msm_kernels`
- :mod:`.verify` — per-proof and combined verification ladders
- :mod:`.backend` — ``TorchBackend``, the ``VerifierBackend`` over them
"""
