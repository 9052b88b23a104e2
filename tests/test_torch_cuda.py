"""The CUDA point kernels on the card, against their plain PyTorch versions
on the same CUDA tensors (equal after canonicalization, every output limb
within the loose bound: the kernels compute in their own radix), the launch
counters and the block size.  Needs an NVIDIA GPU
with nvcc: marked ``cuda`` and skipped elsewhere.  On the machine with the
card (no JAX there, so without tests/conftest.py):
``python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q``."""

import numpy as np
import pytest
import torch

from cpzk_tpu_torch.ops import limbs, point_kernels as pk

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def coords(dev, n, count, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.integers(-limbs.BOUND, limbs.BOUND + 1, size=(20, n))
                             .astype(np.int32)).to(dev) for _ in range(count)]


def assert_canonical_equal(out, ref):
    for a, b in zip(out, ref):
        assert torch.equal(limbs.canonical(a), limbs.canonical(b))
        assert int(a.abs().max()) <= limbs.BOUND


@pytest.mark.parametrize("n", [1, 127, 4096])
def test_kernels_match_plain_on_card(dev, n):
    c = coords(dev, n, 8, n)
    pk.reset_launches()
    out = pk.point_add(tuple(c[:4]), tuple(c[4:]))
    ref = pk.point_add_plain(tuple(c[:4]), tuple(c[4:]))
    assert_canonical_equal(out, ref)
    out = pk.point_double_k(tuple(c[:4]), 4)
    ref = pk.point_double_k_plain(tuple(c[:4]), 4)
    torch.cuda.synchronize()
    assert_canonical_equal(out, ref)
    assert pk.LAUNCHES == {"point_add": 1, "point_double_k": 1}


def test_block_size_covers_every_sm(dev):
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for n in (1, 127, 32 * sms, 6144, 16384, 18432, 1 << 20):
        threads = pk.block_threads(n, dev)
        assert threads % 32 == 0 and 32 <= threads <= 256
        if n >= 32 * sms:
            assert -(-n // threads) >= sms
