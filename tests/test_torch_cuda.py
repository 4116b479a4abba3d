"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: they need an NVIDIA Hopper GPU and nvcc, and skip on a host
without them. On the card:  python -m pytest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from cometbft_tpu_torch.crypto import ed25519_ref as ed
from cometbft_tpu_torch.ops import ed25519_fused as kf
from cometbft_tpu_torch.ops import ed25519_kernel as ek

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA Hopper GPU (torch.cuda is unavailable)")
    from cometbft_tpu_torch.device import default_device

    return default_device()


def _batch(seed, n=200, pad=256):
    rng = np.random.default_rng(seed)
    pubs, msgs, sigs = [], [], []
    for i in range(n):
        m = rng.bytes(int(rng.integers(0, 64)))
        pub, (sig,) = ed.sign_many(rng.bytes(32), [m])
        if i % 5 == 0:
            sig = sig[:7] + bytes([sig[7] ^ 2]) + sig[8:]
        if i % 13 == 0:
            pub, m, sig = rng.bytes(32), rng.bytes(4), rng.bytes(64)
        pubs.append(pub)
        msgs.append(m)
        sigs.append(sig)
    return pubs, msgs, sigs, ek.pack_batch(pubs, msgs, sigs, pad_to=pad)


def test_ed25519_verify_kernel_equals_plain(card):
    pubs, msgs, sigs, pb = _batch(1)
    rows = torch.from_numpy(kf.pack_rows(pb)).to(card)
    before = kf.ed25519_verify.launches
    got = kf.ed25519_verify(rows)
    want = kf.ed25519_verify_plain(rows, kf.base_points(card))
    torch.cuda.synchronize()
    assert kf.ed25519_verify.launches == before + 1
    assert torch.equal(got, want)
    exp = [ed.verify(p, m, s) for p, m, s in zip(pubs, msgs, sigs)]
    assert got.cpu().numpy()[:len(pubs)].astype(bool).tolist() == exp


def test_tally_quorum_kernel_equals_plain(card):
    rng = np.random.default_rng(2)
    B, C = 4096, 12
    powers = rng.integers(1, (2**63 - 1) // 8 // B, B)
    counted = rng.random(B) < 0.9
    cids = rng.integers(0, C, B).astype(np.int32)
    valid = (rng.random(B) < 0.8).astype(np.int32)
    th = np.stack([ek.threshold_limbs(int(t))[0]
                   for t in rng.integers(0, 2**60, C)])
    rows = torch.from_numpy(kf.pack_rows(
        ek.pack_batch([], [], [], pad_to=B), ek.power_limbs(powers),
        counted, cids, th)).to(card)
    v = torch.from_numpy(valid).to(card)
    before = kf.tally_quorum.launches
    tk, qk = kf.tally_quorum(v, rows, C)
    tp, qp = kf.tally_quorum_plain(v, rows, C)
    torch.cuda.synchronize()
    assert kf.tally_quorum.launches == before + 1
    assert torch.equal(tk, tp) and torch.equal(qk, qp)
