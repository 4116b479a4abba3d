"""The port's valset table against the JAX package's: the plain build equals
the JAX XLA build (`_build_core` relaid by `_blocked_i16`) entry for entry,
through convert.valset_table_from_jax, with the same ok bits. So does the
host build of the table kernel's lane programs (csrc/valset_table_quad.cuh,
the quad and the warp entry's), beside the one-thread host reference. The
JAX build compiles for tens of seconds on the CPU, so only this file runs
it, at one shape (128 validators)."""
import functools
import shutil

import numpy as np
import pytest
import torch

from cometbft_tpu.ops import ed25519_cached as jec
from cometbft_tpu.ops import ed25519_kernel as jek
from cometbft_tpu_torch import convert
from cometbft_tpu_torch.crypto import ed25519_ref as ed
from cometbft_tpu_torch.ops import _build
from cometbft_tpu_torch.ops import ed25519_cached as ec

torch.set_num_threads(1)

needs_cxx = pytest.mark.skipif(
    shutil.which("c++") is None and shutil.which("g++") is None,
    reason="no C++ compiler for the host build of the kernel arithmetic")


def _edge_set(rng):
    """116 keys drawn from rng and six edge keys: 0xff x 32, y = 2 (not on
    the curve), a 31-byte key, the identity, y = 1 with the sign bit,
    zeros."""
    pubs = [ed.pubkey_from_seed(rng.bytes(32)) for _ in range(116)]
    return pubs + [b"\xff" * 32, b"\x02" + bytes(31), b"\x01" * 31,
                   ed.pt_compress(ed.IDENT),
                   int.to_bytes(1 | (1 << 255), 32, "little"), bytes(32)]


def _jax_table(pubs, M):
    """The JAX package's table for the key list padded to M, built 128
    validators at a time (one compiled shape) -> the port's ValsetTable."""
    ay, asign, lenok = jec._pack_pub_arrays(pubs, M)
    tabs, oks = [], []
    for b in range(0, M, 128):
        tbl, ok = jec._build_core(ay[b:b + 128], asign[b:b + 128])
        tabs.append(np.asarray(jec._blocked_i16(tbl)))
        oks.append(np.asarray(ok))
    ok = np.concatenate(oks) & lenok
    p5 = jek.power_limbs(np.zeros(M, np.int64))
    return convert.valset_table_from_jax(np.concatenate(tabs), ok, p5, M)


def test_plain_table_build_equals_the_jax_build():
    rng = np.random.default_rng(21)
    pubs = _edge_set(rng)
    M = 128  # one table block; the last slots stay dead
    ay, asign, lenok = jec._pack_pub_arrays(pubs, M)
    tbl, ok = jec._build_core(ay, asign)
    ok = np.asarray(ok) & lenok
    tab16 = np.asarray(jec._blocked_i16(tbl))
    p5 = jek.power_limbs(rng.integers(0, 2**40, M))
    jt = convert.valset_table_from_jax(tab16, ok, p5, M)

    a_raw, lenok = ec._pack_pub_arrays(pubs, M)
    tab, ok_port = ec.valset_table_build(torch.from_numpy(a_raw),
                                         torch.from_numpy(lenok))
    assert torch.equal(tab, jt.tab)
    assert torch.equal(ok_port, jt.ok)
    assert np.array_equal(jt.power5.numpy(), p5) and jt.n_vals == M
    ok_port = ok_port.numpy()
    assert ok_port[:116].all()
    assert ok_port[116] and ok_port[119] and ok_port[120] and ok_port[121]
    assert not ok_port[117] and not ok_port[118] and not ok_port[122:].any()


def _host_build(fn, a_raw, lenok):
    """A host table build (cbt_host_table_build*) over (M, 32) key bytes ->
    (tab, ok & lenok) as the wrapper returns them."""
    M = a_raw.shape[0]
    tab = np.zeros((M * ec.ENT_PER_VAL, 3, 10), np.int32)
    ok = np.zeros(M, np.uint8)
    fn(np.ascontiguousarray(a_raw).ctypes.data, M, tab.ctypes.data,
       ok.ctypes.data)
    return torch.from_numpy(tab), torch.from_numpy(ok.astype(bool) & lenok)


@functools.lru_cache(maxsize=None)
def _case(live):
    """The key bytes of a case and the three tables the host lane programs
    are held to: one-thread host, plain and JAX."""
    if live == 122:
        pubs, M = _edge_set(np.random.default_rng(21)), 128
    else:
        rng = np.random.default_rng(live)
        pubs, M = [ed.pubkey_from_seed(rng.bytes(32))
                   for _ in range(live)], 256
    a_raw, lenok = ec._pack_pub_arrays(pubs, M)
    ref = _host_build(_build.host_lib().cbt_host_table_build, a_raw, lenok)
    plain = ec.valset_table_build_plain(torch.from_numpy(a_raw),
                                        torch.from_numpy(lenok))
    jt = _jax_table(pubs, M)
    return a_raw, lenok, ref, plain, (jt.tab, jt.ok)


@needs_cxx
@pytest.mark.parametrize("live", [122, 33, 127])
@pytest.mark.parametrize("program", ["quad", "warp"])
def test_host_lane_programs_equal_the_reference_plain_and_jax(program, live):
    """cbt_host_table_build_quad / _warp run the table kernel's entries'
    lane programs with a quad's four lanes on one thread. On the edge set
    (122 live of 128) and on 256-slot tables whose live keys end inside a
    block's 32-validator group (33 and 127 live; the rest zero bytes, which
    decode), their tables and ok bits equal the one-thread host build, the
    plain build and the JAX build, byte for byte."""
    a_raw, lenok, *tables = _case(live)
    tab, ok = _host_build(
        getattr(_build.host_lib(), f"cbt_host_table_build_{program}"),
        a_raw, lenok)
    for want_tab, want_ok in tables:
        assert torch.equal(tab, want_tab) and torch.equal(ok, want_ok)
    assert int(ok.sum()) == (120 if live == 122 else live)
