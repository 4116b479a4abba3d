"""The port's valset table against the JAX package's: the plain build equals
the JAX XLA build (`_build_core` relaid by `_blocked_i16`) entry for entry,
through convert.valset_table_from_jax, with the same ok bits. The JAX build
compiles for tens of seconds on the CPU, so only this file runs it."""
import numpy as np
import torch

from cometbft_tpu.ops import ed25519_cached as jec
from cometbft_tpu.ops import ed25519_kernel as jek
from cometbft_tpu_torch import convert
from cometbft_tpu_torch.crypto import ed25519_ref as ed
from cometbft_tpu_torch.ops import ed25519_cached as ec

torch.set_num_threads(1)


def test_plain_table_build_equals_the_jax_build():
    rng = np.random.default_rng(21)
    pubs = [ed.pubkey_from_seed(rng.bytes(32)) for _ in range(116)]
    pubs += [b"\xff" * 32, b"\x02" + bytes(31), b"\x01" * 31,
             ed.pt_compress(ed.IDENT), int.to_bytes(1 | (1 << 255), 32,
                                                    "little"), bytes(32)]
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
