"""What the benchmark takes from the program under test
(cometbft_tpu_torch): its objects, built from the benchmark's plain
inputs, its entry points, and its kernel launch counters and names.

The program is imported inside these functions, so that the harness can
say why it stops (no card, no program) before anything loads it.
"""
from __future__ import annotations

from typing import Dict, Sequence


class SetupError(RuntimeError):
    """The program's objects disagree with the benchmark's inputs."""


def valset(pubs: Sequence[bytes], powers: Sequence[int]):
    """The program's ValidatorSet of keys and powers given in set order;
    its own order has to be the same."""
    from cometbft_tpu_torch.crypto.keys import PubKey
    from cometbft_tpu_torch.types.validator import Validator, ValidatorSet

    vs = ValidatorSet([Validator(PubKey(p), int(w))
                       for p, w in zip(pubs, powers)])
    if [v.pub_key.data for v in vs.validators] != list(pubs):
        raise SetupError("the program orders the validator set otherwise")
    return vs


def block_id(bid: tuple):
    from cometbft_tpu_torch.types.block_id import BlockID, PartSetHeader

    block_hash, total, psh_hash = bid
    return BlockID(block_hash, PartSetHeader(total, psh_hash))


def commit(vs, h) -> object:
    """The program's Commit of a fixtures.Height over `vs`."""
    from cometbft_tpu_torch.types.commit import (
        BLOCK_ID_FLAG_COMMIT, Commit, CommitSig,
    )
    from cometbft_tpu_torch.types.timestamp import Timestamp

    sigs = [CommitSig(BLOCK_ID_FLAG_COMMIT, v.address, Timestamp(s, n), sig)
            if here else CommitSig()
            for v, s, n, sig, here in zip(vs.validators, h.secs, h.nanos,
                                          h.sigs, h.present)]
    return Commit(h.height, h.round, block_id(h.block_id), sigs)


def kernel_wrappers() -> Dict[str, object]:
    """The program's kernel wrappers, each counting its launches."""
    from cometbft_tpu_torch.ops import ecdsa_fused as ef
    from cometbft_tpu_torch.ops import ed25519_cached as ec
    from cometbft_tpu_torch.ops import ed25519_fused as kf
    from cometbft_tpu_torch.ops import ed25519_stamp as es
    from cometbft_tpu_torch.ops import sr25519_kernel as srk

    return {"ed25519_verify": kf.ed25519_verify,
            "tally_quorum": kf.tally_quorum,
            "valset_table_build": ec.valset_table_build,
            "cached_verify": ec.ed25519_verify_cached,
            "tally_quorum_cached": ec.tally_quorum_cached,
            "stamp_rows": es.stamp_rows,
            "sr25519_verify": srk.sr25519_verify,
            "ecdsa_verify": ef.ecdsa_verify}


def launches() -> int:
    """Kernel launches so far, over every wrapper."""
    return sum(fn.launches for fn in kernel_wrappers().values())


# Each kernel's name in a device trace (the __global__ functions of the
# program's csrc/*.cu) -> the wrapper key above.
KERNEL_NAMES = (
    ("ed25519_verify_cached", "cached_verify"),
    ("ed25519_verify_kernel", "ed25519_verify"),
    ("carry_quorum_kernel", "carry_quorum"),
    ("tally_kernel", "tally_quorum"),
    ("valset_table", "valset_table_build"),
    ("stamp_rows_kernel", "stamp_rows"),
    ("sr25519_verify_kernel", "sr25519_verify"),
    ("ecdsa_verify_kernel", "ecdsa_verify"),
)


def kernel_key(trace_name: str):
    """The wrapper key of a device trace's kernel name, or None for a
    kernel that is not the program's (a PyTorch fill or copy)."""
    for needle, key in KERNEL_NAMES:
        if needle in trace_name:
            return key
    return None
