"""Commits of a mixed ed25519/sr25519 validator set: the port's
VerifyCommitLight and VerifyCommit with device_batch_fn("cpu") (the plain
PyTorch kernels) against the benchmark's plain reference
(portbench/reference/), which shares no code with the port; the
reference's own keccak and merlin against their ground truths; and the
stage readings and spans that crypto/batch.py and types/validation.py
record of a call."""
import hashlib
import os

import numpy as np
import pytest
import torch

from cometbft_tpu_torch.crypto import batch as tbatch
from cometbft_tpu_torch.crypto import sr25519_ref as psr
from cometbft_tpu_torch.libs import metrics as tmetrics
from cometbft_tpu_torch.libs import tracing
from cometbft_tpu_torch.ops import sr25519_kernel as srk
from cometbft_tpu_torch.types import commit as tcommit
from cometbft_tpu_torch.types import validation as tv
from portbench import fixtures, program
from portbench.reference import sr25519 as rsr
from portbench.reference import verdicts
from portbench.traffic import commit_mixed as cm

CHAIN = "portbench-mixed"
HEIGHT = 2_000_001
N_ED = N_SR = 24

# The plain versions run many small ops: one thread per test process keeps
# parallel test workers from oversubscribing the host.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def mixed():
    """A seeded 48-validator set, 24 keys of each type at equal power, and
    one signed height of it."""
    keys = cm.MixedKeys(11, {"ed25519": N_ED, "sr25519": N_SR})
    powers = [1000] * (N_ED + N_SR)
    h = cm.signed_height(keys, powers, CHAIN, HEIGHT,
                         fixtures.rng(11, fixtures.HEIGHTS), 2_000_000_000)
    pubs = [keys.pubs[k] for k in h.order]
    types = [keys.types[k] for k in h.order]
    return h, pubs, types, cm.valset(pubs, types, h.powers)


def _commit(mixed, case):
    """The height's commit with the case's change, and the positions
    that are present."""
    h, pubs, types, vs = mixed
    c = program.commit(vs, h)
    present = list(h.present)
    light = verdicts.light_collect(h.powers, present)[0]
    first = {kt: next(i for i in light[5:] if types[i] == kt)
             for kt in ("ed25519", "sr25519")}
    sigs = c.signatures
    if case == "bad_ed25519":
        i = first["ed25519"]
        sigs[i].signature = fixtures.flip(h.sigs[i], 9, 2)
    elif case == "bad_sr25519":
        i = first["sr25519"]
        sigs[i].signature = fixtures.flip(h.sigs[i], 40, 5)
    elif case == "no_marker":
        i = first["sr25519"]
        sigs[i].signature = h.sigs[i][:63] + bytes([h.sigs[i][63] & 0x7F])
    elif case == "noncanonical_r":
        i = first["sr25519"]
        sigs[i].signature = (rsr.P + 1).to_bytes(32, "little") \
            + h.sigs[i][32:]
    elif case == "short":
        for i in fixtures.short_absent(h.powers):
            sigs[i] = tcommit.CommitSig()
            present[i] = False
    return c, present


def _reference_verdict(mixed, c, present, light: bool):
    h, pubs, types, _ = mixed
    if light:
        idxs, tallied, needed = verdicts.light_collect(h.powers, present)
    else:
        idxs = [i for i, here in enumerate(present) if here]
        tallied = sum(h.powers[i] for i in idxs)
        needed = verdicts.two_thirds(h.powers)
    bad = {i for i in idxs
           if not cm.REFERENCE[types[i]](pubs[i], h.msgs[i],
                                         c.signatures[i].signature)}
    return verdicts.light_verdict(idxs, tallied, needed, bad)


def _port_verdict(c, vs, light: bool):
    entry = tv.verify_commit_light if light else tv.verify_commit
    try:
        entry(CHAIN, vs, c.block_id, HEIGHT, c, tv.device_batch_fn("cpu"))
    except tv.VerificationError as e:
        return (type(e).__name__, e.idx) if hasattr(e, "idx") \
            else (type(e).__name__,)
    return None


@pytest.mark.parametrize("light", [True, False], ids=["light", "full"])
@pytest.mark.parametrize("case", ["valid", "bad_ed25519", "bad_sr25519",
                                  "no_marker", "noncanonical_r", "short"])
def test_mixed_commit_verdicts_equal_the_references(mixed, case, light):
    c, present = _commit(mixed, case)
    want = _reference_verdict(mixed, c, present, light)
    assert _port_verdict(c, mixed[3], light) == want
    expect_bad = case not in ("valid", "short")
    assert (want is not None and want[0] == verdicts.BAD_SIG) == expect_bad
    assert (want == (verdicts.LOW_POWER,)) == (case == "short")


@pytest.mark.parametrize("n", [0, 1, 135, 136, 137, 1000])
def test_reference_keccak_matches_hashlib_sha3(n):
    data = np.random.default_rng(n).bytes(n)
    assert rsr.sha3_256(data) == hashlib.sha3_256(data).digest()


def test_reference_merlin_conformance_vector():
    """merlin/src/transcript.rs, test_transcript_equivalence_simple."""
    t = rsr.Transcript(b"test protocol")
    t.append_message(b"some label", b"some data")
    assert t.challenge_bytes(b"challenge", 32).hex() == (
        "d5a21972d0d5fe320c0d263fac7fffb8145aa640af6e9bca177c03c7efcf0615")


def test_reference_signer_agrees_with_the_port():
    """Keys equal the port's; the lockstep signer equals the scalar one
    byte for byte; each side verifies the other's signatures."""
    rng = np.random.default_rng(5)
    seeds = [rng.bytes(32) for _ in range(3)]
    keys = [rsr.Key(s) for s in seeds]
    assert [k.pub for k in keys] == [psr.pubkey_from_seed(s) for s in seeds]
    msgs = [rng.bytes(int(n)) for n in (0, 3, 120, 120, 121, 300)]
    ks = [keys[i % 3] for i in range(len(msgs))]
    sigs = rsr.sign_batch(ks, msgs)
    assert sigs == [k.sign(m) for k, m in zip(ks, msgs)]
    assert all(psr.verify(k.pub, m, s) for k, m, s in zip(ks, msgs, sigs))
    port_sig = psr.sign(seeds[0], msgs[2], b"\x01" * 32)
    assert rsr.verify(keys[0].pub, msgs[2], port_sig)
    assert not rsr.verify(keys[0].pub, msgs[3], port_sig)


def test_challenge_scalars_are_the_packs_own():
    """pack_batch_sr with the challenge stage's scalars equals it without,
    native and plain; malformed rows included."""
    rng = np.random.default_rng(3)
    key = rsr.Key(rng.bytes(32))
    msgs = [rng.bytes(int(n)) for n in (110, 110, 111, 0)]
    sigs = [key.sign(m) for m in msgs]
    pubs = [key.pub, key.pub[:31], key.pub, key.pub]
    sigs[2] = sigs[2][:63]
    for native in (True, False):
        k_red = srk.challenge_scalars(pubs, msgs, sigs, native)
        assert k_red.shape == (4, 32)
        np.testing.assert_array_equal(
            srk.pack_batch_sr(pubs, msgs, sigs, native=native, k_red=k_red),
            srk.pack_batch_sr(pubs, msgs, sigs, native=native))
    assert srk.challenge_scalars([], [], []).shape == (0, 32)


def _light_call(mixed):
    c, _ = _commit(mixed, "valid")
    tv.verify_commit_light(CHAIN, mixed[3], c.block_id, HEIGHT, c,
                           tv.device_batch_fn("cpu"))


def test_group_readings_name_both_key_types(mixed):
    h, _, types, _ = mixed
    rows_before = tbatch.rows_verified()
    _light_call(mixed)
    vrec, brec = tv.call_stats()[-1], tbatch.call_stats()[-1]
    idxs = verdicts.light_collect(h.powers, h.present)[0]
    want = {kt: sum(types[i] == kt for i in idxs)
            for kt in ("ed25519", "sr25519")}
    groups = {g["key_type"]: g for g in brec["groups"]}
    assert {kt: g["rows"] for kt, g in groups.items()} == want
    assert vrec["rows"] == len(idxs) == sum(want.values())
    assert all(g["cols"] == 128 for g in groups.values())
    assert groups["sr25519"]["challenges"] > 0
    assert groups["ed25519"]["challenges"] == 0
    for g in groups.values():
        stages = sum(g[s] for s in tbatch.GROUP_STAGES)
        assert 0 < stages <= g["ms"]
        assert min(g["pack"], g["dispatch"], g["wait"]) > 0
    assert 0 < brec["split"] + sum(g["ms"] for g in groups.values()) \
        <= brec["ms"] <= vrec["batch"]
    assert min(vrec["collect"], vrec["sign_bytes"]) > 0
    after = tbatch.rows_verified()
    assert {kt: after[kt] - rows_before.get(kt, 0) for kt in want} == want
    text = tmetrics.NodeMetrics().expose_text()
    for kt in want:
        assert (f'cometbft_crypto_verify_sigs_total{{key_type="{kt}"}} '
                f'{after[kt]:g}') in text


def test_spans_open_only_under_a_tracer(mixed):
    """With a tracer the call's spans carry the groups' args; with none
    installed nothing records a span event, and the readings still do."""
    tr = tracing.enable()
    try:
        _light_call(mixed)
    finally:
        tracing.disable()
    names = [e["name"] for e in tr.events()]
    for name in ("validation.collect", "validation.sign_bytes",
                 "batch.group", "batch.challenges", "batch.pack",
                 "batch.dispatch", "batch.wait"):
        assert name in names
    assert names.count("batch.group") == 2
    assert names.count("batch.challenges") == 1
    args = {e["args"]["key_type"]: e["args"] for e in tr.events()
            if e["name"] == "batch.group"}
    last = {g["key_type"]: g for g in tbatch.call_stats()[-1]["groups"]}
    assert {kt: (a["rows"], a["cols"]) for kt, a in args.items()} == {
        kt: (g["rows"], g["cols"]) for kt, g in last.items()}
    seen, calls = len(tr.events()), len(tv.call_stats())
    _light_call(mixed)
    assert tracing.tracer() is None and len(tr.events()) == seen
    assert tv.call_stats()[-1] is not None
    assert len(tv.call_stats()) == min(calls + 1, tv.call_stats().maxlen)


def test_a_kernel_put_in_by_a_test_is_one_group_of_its_rows():
    """A kernel with no `cols` (a test's) pads nothing: its group reads
    its own rows as columns, and no stage but the rows' gathering."""
    pubs = [tbatch.PubKey(os.urandom(32), "sr25519") for _ in range(3)]
    got = tbatch.verify_batch(pubs, [b"m"] * 3, [b"s" * 64] * 3,
                              device="cpu", breaker=tbatch.CircuitBreaker(),
                              kernels={"sr25519": lambda p, m, s, device:
                                       np.ones(len(p), bool)})
    assert got.tolist() == [True] * 3
    (g,) = tbatch.call_stats()[-1]["groups"]
    assert (g["key_type"], g["rows"], g["cols"]) == ("sr25519", 3, 3)
    assert g["challenges"] == g["dispatch"] == g["wait"] == 0
    assert g["pack"] > 0
