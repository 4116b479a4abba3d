"""The two tally kernels' design against the plain versions and the JAX
package, on the same seeded numpy inputs.

csrc/tally_quorum.cu reads each column once, by a grid sized by B, and
combines block partials with integer atomics; its per-column accumulation,
warp combine and finish live in csrc/tally_core.cuh, which the host build
runs with the kernel's own block and thread partition (`cbt_host_tally`).
Here that host build, `tally_quorum_plain` / `tally_quorum_cached_plain`
and the JAX `ed25519_kernel.tally_core` + `quorum_core` must agree bit for
bit on every edge case of `edge_cases.TALLY_CASES`. The CUDA kernel itself
runs in tests/test_torch_cuda.py."""
import re
import shutil

import numpy as np
import pytest
import torch

from cometbft_tpu.ops import ed25519_kernel as jek
from cometbft_tpu_torch.edge_cases import TALLY_CASES, tally_edge_case
from cometbft_tpu_torch.ops import _build
from cometbft_tpu_torch.ops import ed25519_cached as ec
from cometbft_tpu_torch.ops import ed25519_fused as kf
from cometbft_tpu_torch.ops import ed25519_kernel as ek

torch.set_num_threads(1)

needs_cxx = pytest.mark.skipif(
    shutil.which("c++") is None and shutil.which("g++") is None,
    reason="no C++ compiler for the host build of the kernel arithmetic")

SMEM_CAP = kf.TALLY_SMEM_COMMITS


def _plain(case, cached):
    valid = torch.from_numpy(case.valid)
    rows = torch.from_numpy(case.rows)
    if cached:
        t, q = ec.tally_quorum_cached_plain(
            valid, rows, torch.from_numpy(case.power5), case.C)
    else:
        t, q = kf.tally_quorum_plain(valid, rows, case.C)
    return t.numpy(), q.numpy()


def host_tally(case, cached):
    """(tally, quorum, shared-memory branch taken) of the host build."""
    rows = np.ascontiguousarray(case.rows)
    valid = np.ascontiguousarray(case.valid)
    power5 = (np.ascontiguousarray(case.power5) if cached
              else np.zeros((1, 5), np.int32))
    tally = np.full((case.C, 6), -1, np.int32)
    quorum = np.full(case.C, 9, np.uint8)
    smem = _build.host_lib().cbt_host_tally(
        int(cached), valid.ctypes.data, rows.ctypes.data, rows.shape[1],
        power5.ctypes.data, power5.shape[0], case.C, tally.ctypes.data,
        quorum.ctypes.data)
    return tally, quorum.astype(bool), smem


def _jax(case):
    t = np.asarray(jek.tally_core(case.valid != 0, case.p5, case.counted,
                                  case.cids, case.C))
    return t, np.asarray(jek.quorum_core(t, case.thresh))


@needs_cxx
@pytest.mark.parametrize("cached", [False, True], ids=["general", "cached"])
@pytest.mark.parametrize("name", [c[0] for c in TALLY_CASES])
def test_host_build_equals_plain_and_jax(name, cached):
    case = tally_edge_case(name, cached)
    t_host, q_host, smem = host_tally(case, cached)
    t_plain, q_plain = _plain(case, cached)
    t_jax, q_jax = _jax(case)
    assert np.array_equal(t_host, t_plain) and np.array_equal(t_host, t_jax)
    assert np.array_equal(q_host, q_plain) and np.array_equal(q_host, q_jax)
    assert [int(x) for x in ek.tally_to_int(t_host)] == case.sums
    thr = [int(x) for x in ek.tally_to_int(case.thresh)]
    assert q_host.tolist() == [s > t for s, t in zip(case.sums, thr)]
    assert smem == (case.C <= SMEM_CAP)


def test_edge_cases_reach_every_edge():
    """The cases hold what their names promise: out-of-range ids, verdicts
    other than 0 and 1, full limbs, thresholds on both sides of the sum,
    the cap crossed, and widths that are not multiples of 4 or of a
    block's 512 columns."""
    case = tally_edge_case("odd_width")
    assert (case.cids < 0).any() and (case.cids >= case.C).any()
    assert set(np.unique(case.valid)) >= {0, 1, 2, -1, 7, -2**31}
    assert (case.p5 == 8191).all(axis=1).any()
    assert {s > t for s, t in zip(case.sums, ek.tally_to_int(
        case.thresh))} == {True, False}
    widths = [B for _, B, _, _ in TALLY_CASES]
    assert any(B % 4 for B in widths) and any(B % 512 for B in widths)
    assert max(C for _, _, C, _ in TALLY_CASES) == SMEM_CAP + 1
    # every limb of every column is 2^13 - 1: a per-limb sum of
    # 2^17 (2^13 - 1) < 2^30 before the carry
    big = tally_edge_case("b_2_17_one_commit", True)
    assert big.sums == [0, (1 << 17) * ((1 << 65) - 1), 0]


@pytest.mark.parametrize("cached", [False, True], ids=["general", "cached"])
def test_wrappers_refuse_more_than_2_17_columns(cached):
    B = (1 << 17) + 4
    valid = torch.zeros(B, dtype=torch.int32)
    if cached:
        rows = torch.zeros(ec.packed_rows_shape(B), dtype=torch.int32)
        call = lambda: ec.tally_quorum_cached(  # noqa: E731
            valid, rows, torch.zeros((8, 5), dtype=torch.int32), 1)
    else:
        rows = torch.zeros((kf.C_THRESH + 1, B), dtype=torch.int32)
        call = lambda: kf.tally_quorum(valid, rows, 1)  # noqa: E731
    with pytest.raises(ValueError, match="2\\^17"):
        call()


def test_shared_memory_cap_matches_the_kernel_header():
    src = (_build.CSRC / "tally_core.cuh").read_text()
    cap = re.search(r"kMaxSmemCommits = (\d+);", src)
    assert cap and int(cap.group(1)) == kf.TALLY_SMEM_COMMITS


def test_cached_wrapper_refuses_an_empty_power5():
    rows = torch.zeros(ec.packed_rows_shape(512), dtype=torch.int32)
    with pytest.raises(ValueError, match="no validator"):
        ec.tally_quorum_cached(torch.zeros(512, dtype=torch.int32), rows,
                               torch.zeros((0, 5), dtype=torch.int32), 1)


@pytest.mark.parametrize("cached", [False, True], ids=["general", "cached"])
def test_wrappers_refuse_short_threshold_rows(cached):
    """Rows that hold fewer threshold words than n_commits * 6 are refused
    (the JAX `_verify_tally_cached` pads them with zero thresholds)."""
    B, C = 8, 2  # one threshold row: 8 words for the 12 that C needs
    valid = torch.ones(B, dtype=torch.int32)
    if cached:
        rows = torch.zeros((ec.V_THRESH + 1, B), dtype=torch.int32)
        p5 = torch.zeros((4, 5), dtype=torch.int32)
        call = lambda c: ec.tally_quorum_cached(  # noqa: E731
            valid, rows, p5, c)
    else:
        rows = torch.zeros((kf.C_THRESH + 1, B), dtype=torch.int32)
        call = lambda c: kf.tally_quorum(valid, rows, c)  # noqa: E731
    with pytest.raises(ValueError, match="fewer thresholds"):
        call(C)
    assert call(1)[0].shape == (1, ek.TALLY_LIMBS)  # one commit fits


@pytest.mark.parametrize("bad", ["negative_power", "limb_2_13",
                                 "negative_limb"])
def test_power_limbs_outside_13_bits_are_refused_on_the_host(bad):
    """The tally kernels' precondition (every power limb < 2^13) is checked
    where the host makes limbs, never on the card."""
    if bad == "negative_power":
        with pytest.raises(ValueError, match="non-negative"):
            ek.power_limbs(np.array([5, -1, 7]))
        return
    p5 = ek.power_limbs(np.array([1, 2**62, 12345]))
    p5[1, 4] = 1 << 13 if bad == "limb_2_13" else -1
    with pytest.raises(ValueError, match="2\\^13"):
        ek.check_power_limbs(p5)
    with pytest.raises(ValueError, match="2\\^13"):
        kf.pack_rows(ek.pack_batch([], [], [], pad_to=3), p5)
