"""The benchmark's plain reference against published vectors: RFC 9496's
ristretto255 encodings and invalid encodings, the one-way map, the merlin
crate's transcript vector and pinned Chaum-Pedersen proofs; the vectorised
versions against the one-element version; valid and tampered rows told
apart by the group equations."""

from __future__ import annotations

import hashlib

import numpy as np
import pytest
import torch

from benchmark.reference import group, merlin, proofs, vecfield

# RFC 9496 appendix A.1: multiples 0..15 of the generator
SMALL_MULTIPLES = """
0000000000000000000000000000000000000000000000000000000000000000
e2f2ae0a6abc4e71a884a961c500515f58e30b6aa582dd8db6a65945e08d2d76
6a493210f7499cd17fecb510ae0cea23a110e8d5b901f8acadd3095c73a3b919
94741f5d5d52755ece4f23f044ee27d5d1ea1e2bd196b462166b16152a9d0259
da80862773358b466ffadfe0b3293ab3d9fd53c5ea6c955358f568322daf6a57
e882b131016b52c1d3337080187cf768423efccbb517bb495ab812c4160ff44e
f64746d3c92b13050ed8d80236a7f0007c3b3f962f5ba793d19a601ebb1df403
44f53520926ec81fbd5a387845beb7df85a96a24ece18738bdcfa6a7822a176d
903293d8f2287ebe10e2374dc1a53e0bc887e592699f02d077d5263cdd55601c
02622ace8f7303a31cafc63f8fc48fdc16e1c8c8d234b2f0d6685282a9076031
20706fd788b2720a1ed2a5dad4952b01f413bcf0e7564de8cdc816689e2db95f
bce83f8ba5dd2fa572864c24ba1810f9522bc6004afe95877ac73241cafdab42
e4549ee16b9aa03099ca208c67adafcafa4c3f3e4e5303de6026e3ca8ff84460
aa52e000df2e16f55fb1032fc33bc42742dad6bd5a8fc0be0167436c5948501f
46376b80f409b29dc2b5f6f0c52591990896e5716f41477cd30085ab7f10301e
e0c418f7c8d9c4cdd7395b93ea124f3ad99021bb681dfc3302a9d99a2e53e64e
""".split()

# RFC 9496 appendix A.2: non-canonical, negative, non-square, negative x y,
# and s = -1 encodings
BAD_ENCODINGS = ["00" + "ff" * 31] + """
ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff7f
f3ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff7f
edffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff7f
0100000000000000000000000000000000000000000000000000000000000000
01ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff7f
ed57ffd8c914fb201471d1c3d245ce3c746fcbe63a3679d51b6a516ebebe0e20
c34c4e1826e5d403b78e246e88aa051c36ccf0aafebffe137d148a2bf9104562
c940e5a4404157cfb1628b108db051a8d439e1a421394ec4ebccb9ec92a8ac78
47cfc5497c53dc8e61c91d17fd626ffb1c49e2bca94eed052281b510b1117a24
f1c6165d33367351b0da8f6e4511010c68174a03b6581212c71c0e1d026c3c72
87260f7a2f12495118360f02c26a470f450dadf34a413d21042b43b9d93e1309
26948d35ca62e643e26a83177332e6b6afeb9d08e4268b650f1f5bbd8d81d371
4eac077a713c57b4f4397629a4145982c661f48044dd3f96427d40b147d9742f
de6a7b00deadc788eb6b6c8d20c0ae96c2f2019078fa604fee5b87d6e989ad7b
bcab477be20861e01e4a0e295284146a510150d9817763caf1a6f4b422d67042
2a292df7e32cababbd9de088d1d1abec9fc0440f637ed2fba145094dc14bea08
f4a9e534fc0d216c44b218fa0c42d99635a0127ee2e53c712f70609649fdff22
8268436f8c4126196cf64b3c7ddbda90746a378625f9813dd9b8457077256731
2810e5cbc2cc4d4eece54f61c6f69758e289aa7ab440b3cbeaa21995c2f4232b
3eb858e78f5a7254d8c9731174a94f76755fd3941c0ac93735c07ba14579630e
a45fdc55c76448c049a1ab33f17023edfb2be3581e9c7aade8a6125215e04220
d483fe813c6ba647ebbfd3ec41adca1c6130c2beeee9d9bf065c8d151c5f396e
8a2e1d30050198c65a54483123960ccc38aef6848e1ec8f5f780e8523769ba32
32888462f8b486c68ad7dd9610be5192bbeaf3b443951ac1a8118419d9fa097b
227142501b9d4355ccba290404bde41575b037693cef1f438c47f8fbf35d1165
5c37cc491da847cfeb9281d407efc41e15144c876e0170b499a96a22ed31e01e
445425117cb8c90edcbc7c1cc0e74f747f2c1efa5630a967c64f287792a48a4b
ecffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff7f
""".split()

# pinned Chaum-Pedersen proofs (the protocol's 109-byte wire; the challenge
# is the Fiat-Shamir scalar of the transcript)
PROOF_VECTORS = [
    {"context": None,
     "y1": "90602c8dfb294061004215d818cb6cdb5437277bcef801fd6ef94aa5955ea53a",
     "y2": "5891b5102a183132a706e68ec336a201f668715b9480c57f719486d79e9c6a46",
     "challenge": "535e459f42e23da8cfe82ab8bac6ebd62e16e4e8d44c5ff248534b18fd024605",
     "proof": "010000002026e296701bd2e334c52a1181e198b52b216205dbb8175bb60f83b05a9ded3353000000"
              "20421eff92cff2a03005743c72a7c2c37b30f69c53de49dd37cb3f8b0e95e6eb7e00000020b9862da4"
              "f0ebc87aa7475ba874e28695fdc705257a6689c055caac352328fd03"},
    {"context": "636f6e746578742d31",
     "y1": "900655db1a04df7f3cc8d7603e9ac3dd89ba70785378ebc3df261ca93ab92b7a",
     "y2": "4edf4c812fc0e7791f552e21987a8c32828ae69c990d3098b1e605a2e2a5f72c",
     "challenge": "5e89b21c0e7bea3fbe55c833f7698f269dcaa7dc0f96fa6da665276a08a68b0e",
     "proof": "01000000208e52e86269b7dc922b5edf034575c5023825afc452c6b81c2729f7ce076b000200000020"
              "c6b86a717f54ee5c3346fb9e75c5957fcbe7bded6a628c2ea9afd6662b5fe41000000020178b92a3"
              "4ab9583b29489b812d96971bb4b7652aa6f829c2ec1e2b2760e95606"},
]


def test_small_multiples():
    acc = group.IDENTITY
    for expected in SMALL_MULTIPLES:
        assert group.encode(acc).hex() == expected
        assert group.decode(bytes.fromhex(expected)) is not None
        acc = group.add(acc, group.G)


@pytest.mark.parametrize("wire", BAD_ENCODINGS)
def test_bad_encodings_rejected(wire):
    assert group.decode(bytes.fromhex(wire)) is None


def test_one_way_map_and_generators():
    digest = hashlib.sha512(b"Ristretto is traditionally a short shot of espresso coffee").digest()
    assert group.encode(group.from_uniform_bytes(digest)).hex() == (
        "3066f82a1a747d45120d1740f14358531a8f04bbffe6a819f86dfe50f44a0a46")
    assert group.encode(group.H).hex() == (
        "c8db6f46e1b91e7e93ace69eab46976efebe07deaf5b9a2a7442fd0236401623")


@pytest.mark.parametrize("xp", ["numpy", "cpu"])
def test_merlin_published_vector(xp):
    t = merlin.Merlin(b"test protocol", 1, xp)
    t.append_message(b"some label", b"some data")
    out = t.challenge_bytes(b"challenge", 32)
    out = out.tobytes() if isinstance(out, np.ndarray) else out.numpy().tobytes()
    assert out.hex() == "d5a21972d0d5fe320c0d263fac7fffb8145aa640af6e9bca177c03c7efcf0615"


def _arr(h: str, xp):
    a = np.frombuffer(bytes.fromhex(h), dtype=np.uint8)[None, :].copy()
    return a if xp == "numpy" else torch.from_numpy(a)


@pytest.mark.parametrize("xp", ["numpy", "cpu"])
@pytest.mark.parametrize("vec", PROOF_VECTORS, ids=["no-context", "context"])
def test_proof_vectors_valid_and_tampered(vec, xp):
    wire = bytes.fromhex(vec["proof"])
    r1, r2, s = proofs.parse_wire(wire)
    ctx = None if vec["context"] is None else _arr(vec["context"], xp)
    wide = merlin.challenge_wide(merlin.protocol_start(xp), ctx, proofs.G_BYTES, proofs.H_BYTES,
                                 _arr(vec["y1"], xp), _arr(vec["y2"], xp),
                                 _arr(r1.hex(), xp), _arr(r2.hex(), xp))
    c = merlin.reduce_wide(wide)[0]
    assert c.to_bytes(32, "little").hex() == vec["challenge"]
    y1, y2 = bytes.fromhex(vec["y1"]), bytes.fromhex(vec["y2"])
    assert group.verify_row(y1, y2, r1, r2, s, c)
    assert not group.verify_row(y1, y2, r1, r2, (s + 1) % group.L, c)
    assert not group.verify_row(y1, y2, r1, r2, s, (c + 1) % group.L)


def test_vectorised_fixed_base_matches_plain():
    rng = np.random.default_rng(5)
    ks = [int.from_bytes(rng.bytes(64), "little") % group.L for _ in range(6)] + [1, 2, group.L - 1]
    bases = [i % 2 for i in range(len(ks))]
    out = vecfield.FixedBase([group.G, group.H], "cpu").mul_encode(ks, bases)
    for i, (k, b) in enumerate(zip(ks, bases)):
        assert out[i].numpy().tobytes() == group.encode(group.mul(k, [group.G, group.H][b]))


def test_made_rows_told_apart_by_group_equations():
    pop = proofs.population(11, 6, "cpu")
    batch = proofs.make_batch(pop, 11, 0, 32, tampered_share=0.5)
    y1, y2 = proofs.statement_items(pop)
    ok = proofs.verify_wires(zip(batch.contexts, y1, y2, batch.items))
    assert ok == [want is None for want in batch.expected]
    assert True in ok and False in ok
