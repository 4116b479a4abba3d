"""The JAX package's kernel test modules on the port (tests/torch_mirror.py):
tests/test_ed25519_kernel.py, test_secp256k1.py, test_sr25519.py and
test_native.py, every test and every parametrised case, with the same
bodies and assertions, on the port's entries over the plain kernels
(`device="cpu"`). The JAX package's run of each is the original file.
tests/test_torch_parity_cached.py runs the cached path's two modules.

The substitutions, where the port is built differently:
  * `device="cpu"` in every call of a kernel entry that defaults to the
    device (the `cpu` names below): the port's default is the card,
    which raises DeviceError here; `use_pallas=False` (the JAX XLA
    route) is `device="cpu"` too.
  * test_secp256k1.py's curve tests: the port's plain curve
    (ops/secp256k1.py) holds a point as an (X, Y, Z) tuple of int64
    tensors, where the JAX module stacks one array (`unstack`); the JAX
    arrays are handed over through `_pt`, the identity is
    `identity(1, "cpu")`, and `base_scalar_mul` takes byte digits and the
    comb table. `ops.ecdsa_pallas` (the JAX Pallas ECDSA kernel) is the
    port's ECDSA route, ops/ecdsa_fused.py.
  * Stand-in kernels (test_sr25519.py's host oracles) take the port's
    `device=` argument.
  * test_native.py: the JAX test forces its pack's numpy fallback by
    stubbing the native loader; the port has no fallback behind the
    native library and selects its numpy plain version with
    `pack_batch(..., native=False)`.
"""
import pytest
import torch

import torch_mirror as tm

# The plain versions run many small ops: one thread per test process keeps
# parallel test workers from oversubscribing the host.
torch.set_num_threads(1)

# test_secp256k1.py: a JAX point array as the port's (X, Y, Z) tuple
PT = '''import torch


def _pt(a):
    """A stacked (..., 3, NLIMBS) point array as the port's (X, Y, Z)."""
    t = torch.as_tensor(np.asarray(a), dtype=torch.int64)
    return (t[..., 0, :], t[..., 1, :], t[..., 2, :])


def to_affine(p):
'''

MODULES = {
    "test_ed25519_kernel.py": (
        [], ("k.verify_batch", "k.verify_tally_kernel")),
    "test_secp256k1.py": ([
        ("def to_affine(p):\n", PT),
        ("for c in curve.unstack(p)]", "for c in p]"),
        ("curve.add(dev[:3], dev[3:])", "curve.add(_pt(dev[:3]), _pt(dev[3:]))"),
        ("curve.double(dev)", "curve.double(_pt(dev))"),
        ("p = curve.from_affine_int(x, y)[None]",
         "p = _pt(curve.from_affine_int(x, y)[None])"),
        ("minus = curve.from_affine_int(x, ref.P - y)[None]",
         "minus = _pt(curve.from_affine_int(x, ref.P - y)[None])"),
        ("ident = np.asarray(curve.identity((1,)))",
         'ident = curve.identity(1, "cpu")'),
        ("curve.scalar_mul_windowed(digs, np.ascontiguousarray(g))",
         "curve.scalar_mul_windowed(torch.as_tensor(digs, "
         "dtype=torch.int64), _pt(np.ascontiguousarray(g)))"),
        ("curve.base_scalar_mul(digs)",
         "curve.base_scalar_mul(torch.as_tensor(digs[:, 0::2] + 16 * "
         "digs[:, 1::2], dtype=torch.int64), torch.as_tensor("
         "curve.base_table8_np(), dtype=torch.int64))"),
        tm.NO_PALLAS,
        ("from cometbft_tpu_torch.ops import ecdsa_pallas as cp",
         "from cometbft_tpu_torch.ops import ecdsa_fused as cp"),
    ], ("ek.verify_batch", "cp.verify_batch")),
    "test_sr25519.py": ([
        ("lambda pubs, msgs, sigs: np.asarray(",
         "lambda pubs, msgs, sigs, device=None: np.asarray("),
    ], ("srk.verify_batch", "cbatch.verify_batch")),
    "test_native.py": ([
        ("""    real_load = native._load
    try:
        native._load = lambda: None  # force fallback
        pb2 = ek.pack_batch(pubs, msgs, sigs)
    finally:
        native._load = real_load
""", """    pb2 = ek.pack_batch(pubs, msgs, sigs, native=False)
"""),
    ], ()),
}

CASES = []
for _name, (_subs, _cpu) in MODULES.items():
    _mod = tm.load(_name, _subs, cpu=_cpu)
    CASES += tm.param_cases(_mod, tm.module_tests(_mod))


@pytest.mark.parametrize("mod,name,args", CASES)
def test_parity_kernels(mod, name, args, request):
    tm.run(mod, name, request, args=args)
