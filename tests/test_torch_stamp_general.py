"""The general stamp on the host (ops/ed25519_stamp.py `stamp_rows_general`,
csrc/stamp_core.cuh `stamp_column_general`): its plain version and the host
build of the kernel's per-thread program equal kf.pack_rows of the native
host pack byte for byte, in every column and row, on every stamp case
(edge_cases.stamp_general_case: chain ids of 0-80 bytes, rows of 1-3
SHA-512 blocks, zero, negative and 10-byte timestamps, nanos at the int32
edges, keys and R with the top bit set, S >= L, dead columns with their
commit ids, thresholds over two rows, clamped template indices); the
wrapper refuses what the kernel does not take; and the fused entry runs
the general kernels over the stamped rows, where every vote signed for
its sign-bytes verifies."""
import shutil

import numpy as np
import pytest
import torch

from cometbft_tpu_torch import edge_cases
from cometbft_tpu_torch.crypto import ed25519_ref as ed
from cometbft_tpu_torch.ops import _build
from cometbft_tpu_torch.ops import ed25519_fused as kf
from cometbft_tpu_torch.ops import ed25519_stamp as es
from cometbft_tpu_torch.types import canonical
from cometbft_tpu_torch.types.timestamp import Timestamp

# the plain versions run many small ops: one thread per test process
torch.set_num_threads(1)

needs_cxx = pytest.mark.skipif(
    shutil.which("c++") is None and shutil.which("g++") is None,
    reason="no C++ compiler for the host build of the kernel arithmetic")


def _operands(case):
    """The case's deltas as CPU tensors, its template entry and its
    thresholds."""
    t = torch.from_numpy
    return ((t(case.dsig), t(case.key), t(case.dts), t(case.dfl),
             t(case.power)), es.template_entry(case.sites, "cpu"),
            t(np.ascontiguousarray(case.thresh, np.int32)))


@pytest.mark.parametrize("name", edge_cases.STAMP_CASES)
def test_plain_general_stamp_equals_pack_rows_of_the_host_pack(name):
    case = edge_cases.stamp_general_case(name)
    deltas, ent, thr = _operands(case)
    before = es.stamp_rows_general.launches
    got = es.stamp_rows_general(*deltas, ent, thr, case.t_rows)
    assert es.stamp_rows_general.launches == before  # the plain version
    assert got.dtype == torch.int32
    assert got.numpy().tobytes() == case.ref.tobytes()
    assert got.shape == case.ref.shape


@needs_cxx
@pytest.mark.parametrize("name", edge_cases.STAMP_CASES)
def test_host_build_of_the_general_stamp_equals_pack_rows(name):
    case = edge_cases.stamp_general_case(name)
    _, ent, _ = _operands(case)
    thr = np.ascontiguousarray(case.thresh, np.int32)
    out = np.zeros_like(case.ref)
    _build.host_lib().cbt_host_stamp_general(
        case.dsig.ctypes.data, case.key.ctypes.data, case.dts.ctypes.data,
        case.dfl.ctypes.data, case.power.ctypes.data, case.B,
        ent.pre_mat.numpy().ctypes.data, ent.pre_len.numpy().ctypes.data,
        ent.pre_mat.shape[1], ent.suf_mat.numpy().ctypes.data,
        ent.suf_len.numpy().ctypes.data, ent.suf_mat.shape[1],
        ent.ts_tag.numpy().ctypes.data, ent.pre_mat.shape[0],
        thr.ctypes.data, thr.size, case.t_rows, out.ctypes.data)
    assert out.tobytes() == case.ref.tobytes()


def test_the_general_cases_reach_every_edge():
    """What the differential tests claim to cover is in their inputs."""
    cases = {n: edge_cases.stamp_general_case(n)
             for n in edge_cases.STAMP_CASES}
    case = cases["dead"]
    live = case.live
    assert (~live).any() and live.sum() > 100
    flags = case.ref[kf.C_FLAGS]
    assert ((flags & 1) != 0).any() and ((flags & 2) != 0).any()  # top bits
    assert ((flags[live] & 4) == 0).any()                         # S >= L
    assert ((flags[live] & 4) != 0).any()
    assert (case.ref[kf.C_CID, ~live] == case.dfl[~live] >> 10).all()
    assert not case.ref[:kf.C_CID, ~live].any()
    secs = (case.dts[:, 0].view(np.uint32).astype(np.int64)
            | (case.dts[:, 1].astype(np.int64) << 32))
    nanos = case.dts[:, 2]
    assert {2**31 - 1, -2**31, 0} <= set(nanos[live].tolist())
    assert {2**63 - 1, -2**63, -1, 0} <= set(secs[live].tolist())
    assert {0, 2**63 - 1} <= set(case.power[live].tolist())
    assert cases["thresholds"].t_rows == 2
    for c in cases.values():
        s_ge_l = [int.from_bytes(c.dsig[b, 32:].tobytes(), "little") >= ed.L
                  for b in range(8)]
        assert s_ge_l[5] and s_ge_l[7] and not s_ge_l[3]


@pytest.mark.parametrize("bad", ["sig", "key", "ts", "flags", "power",
                                 "thr", "t_rows"])
def test_stamp_rows_general_refuses_what_the_kernel_does_not_take(bad):
    case = edge_cases.stamp_general_case("sweep", B=128)
    (sig, key, ts, flags, power), ent, thr = _operands(case)
    t_rows = case.t_rows
    if bad == "sig":
        sig = sig[:, :32].contiguous()
    elif bad == "key":
        key = key.to(torch.int32)
    elif bad == "ts":
        ts = ts.t()
    elif bad == "flags":
        flags = flags[:-1]
    elif bad == "power":
        power = power.to(torch.int32)
    elif bad == "thr":
        thr = thr.to(torch.int64)
    else:
        t_rows = 0
    with pytest.raises(ValueError):
        es.stamp_rows_general(sig, key, ts, flags, power, ent, thr, t_rows)


def test_verify_tally_delta_general_runs_the_general_kernels():
    """The fused entry on the CPU: the general kernels' verdicts, tallies
    and quorum bits over the stamped rows. Half of the live rows carry
    real signatures of their sign-bytes, and those verify; no dead column
    does."""
    case = edge_cases.stamp_general_case("dead", B=128)
    live = np.flatnonzero(case.live)
    seeds = [bytes([k]) * 32 for k in range(len(live) // 2)]
    for seed, b in zip(seeds, live):
        chain, height, rnd, bid = case.site_params[case.dfl[b] >> 2 & 0xFF]
        secs = int(case.dts[b, 0].view(np.uint32)) | (
            int(case.dts[b, 1]) << 32)
        msg = canonical.canonical_vote_bytes(
            chain, canonical.PRECOMMIT_TYPE, height, rnd, bid,
            Timestamp(secs, int(case.dts[b, 2])))
        pub, (sig,) = ed.sign_many(seed, [msg])
        case.key[b] = np.frombuffer(pub, np.uint8)
        case.dsig[b] = np.frombuffer(sig, np.uint8)
    deltas, ent, thr = _operands(case)
    rows = es.stamp_rows_general(*deltas, ent, thr, case.t_rows)
    want = kf.verify_tally_rows(rows.numpy(), case.C, "cpu")
    got = es.verify_tally_delta_general(case.dsig, case.key, case.dts,
                                        case.dfl, case.power, ent, case.C,
                                        case.thresh, "cpu")
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert got[0].numpy()[live[:len(seeds)]].all()
    assert not got[0].numpy()[~case.live].any()
