"""The JAX package's cached-valset test modules on the port
(tests/torch_mirror.py): tests/test_ed25519_cached_host.py and
test_ed25519_cached.py, every test, with the same bodies and assertions,
on the port's cached path over the plain kernels (`device="cpu"`). The
JAX package's run of each is the original file (test_ed25519_cached.py
skips there without a TPU).

The substitutions, where the port is built differently:
  * `device="cpu"` in every call of a table or verify entry that
    defaults to the device (the `cpu` names below): the port's default
    is the card, which raises DeviceError here.
    `StreamVerifier(use_pallas=True)` is `StreamVerifier(device="cpu")`,
    whose same-valset chunks take the cached kernel as the JAX Pallas
    route's do.
  * test_ed25519_cached_host.py: the port's table cache keys a table by
    (content key, device), and a table carries its device.
  * test_ed25519_cached.py's module skip (the JAX Pallas kernel compiles
    for hours in interpret mode) does not apply: its tests run on the
    port's plain kernels.
"""
import pytest
import torch

import torch_mirror as tm

# The plain versions run many small ops: one thread per test process keeps
# parallel test workers from oversubscribing the host.
torch.set_num_threads(1)

MODULES = {
    "test_ed25519_cached_host.py": ([
        ("""                          np.zeros(padded, np.int64))""",
         """                          np.zeros(padded, np.int64), device="cpu")"""),
        ("key = ec._memo_cache_key(target_pubs, None)",
         'key = (ec._memo_cache_key(target_pubs, None), "cpu")'),
    ], ("ec.warm_incremental",)),
    "test_ed25519_cached.py": ([
        ("StreamVerifier(use_pallas=True,", 'StreamVerifier(device="cpu",'),
    ], ("ec.verify_batch_cached", "ec.table_for_pubs", "ec.build_table",
        "ec.warm_incremental")),
}

CASES = []
for _name, (_subs, _cpu) in MODULES.items():
    _mod = tm.load(_name, _subs, cpu=_cpu)
    CASES += tm.param_cases(_mod, tm.module_tests(_mod))


@pytest.mark.parametrize("mod,name,args", CASES)
def test_parity_cached(mod, name, args, request):
    tm.run(mod, name, request, args=args)
