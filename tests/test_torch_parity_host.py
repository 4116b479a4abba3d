"""The JAX package's host test modules on the port (tests/torch_mirror.py):
tests/test_validation.py, test_validator_set.py, test_canonical.py,
test_merkle.py, test_ed25519_ref.py and test_batch_breaker.py, every test
and every parametrised case, with the same bodies and assertions on the
port's modules. The JAX package's run of each is the original file.

The substitutions, where the port is built differently:
  * test_validation.py's "device-xla" batch_fn is
    `device_batch_fn(device="cpu")` (the JAX `use_pallas=False`): the
    port's default device is the card, which raises DeviceError here.
  * test_validator_set.py's two memo tests call `table_for_valset` with
    `device="cpu"`, the same device rule, and their stand-ins for
    `table_for_pubs` take its `device` argument.
  * test_batch_breaker.py (C1: the port never verifies on the host behind
    a device fault): each faulted call, whose host verdicts the JAX test
    checks, raises DeviceError instead; the breaker's state, trips,
    probes and the failpoint's fires are checked unchanged, and in the
    flaky-device test every call that did not fault equals the oracle.
    The stand-in kernel takes the port's `device=` argument, the
    `device_batch_fn` and `[crypto]` batch_fn run on `device="cpu"`.
"""
import pytest
import torch

import torch_mirror as tm

# The plain versions run many small ops: one thread per test process keeps
# parallel test workers from oversubscribing the host.
torch.set_num_threads(1)

BREAKER_CALL = ("cbatch.verify_batch(pubs, msgs, sigs, kernels=KERNELS, "
                "breaker=brk)")

MODULES = {
    "test_validation.py": ([tm.NO_PALLAS], ()),
    "test_validator_set.py": ([
        ("def fake_table_for_pubs(pubs, powers=None):",
         "def fake_table_for_pubs(pubs, powers=None, device=None):"),
        ("lambda pubs, powers=None: _T()",
         "lambda pubs, powers=None, device=None: _T()"),
    ], ("ec.table_for_valset",)),
    "test_canonical.py": ([], ()),
    "test_merkle.py": ([], ()),
    "test_ed25519_ref.py": ([], ()),
    "test_batch_breaker.py": ([
        ("from cometbft_tpu_torch.libs import failpoints as fp\n",
         "from cometbft_tpu_torch.libs import failpoints as fp\n"
         + tm.DEVICE_ERROR),
        ("def oracle_kernel(pub_bytes, msgs, sigs):",
         "def oracle_kernel(pub_bytes, msgs, sigs, device=None):"),
        # test_device_fault_trips_breaker_host_path_correct
        tm.c1(BREAKER_CALL, "    # 1st faulted batch: breaker still closed "
              "(threshold 2), host path\n"),
        tm.c1(BREAKER_CALL, "    # 2nd faulted batch: breaker trips\n"),
        tm.c1(BREAKER_CALL, '    fires_before = fp.registry().stats('
              '"crypto.device_dispatch")["fires"]\n'),
        # test_breaker_reprobes_and_recovers: its first call
        tm.c1(BREAKER_CALL, '    fp.arm("crypto.device_dispatch", '
              '"raise")\n'),
        # test_probe_failure_keeps_breaker_open
        tm.c1(BREAKER_CALL, '    fp.arm("crypto.device_dispatch", '
              '"raise")\n', checked=False),
        tm.c1(BREAKER_CALL, "    # still faulted: the probe fails and the "
              "breaker stays open\n"),
        # test_flake_action_degrades_not_halts: flake:2 faults the 2nd
        # and 4th dispatch
        ("    for _ in range(4):\n"
         f"        got = {BREAKER_CALL}\n",
         "    for i in range(4):\n"
         "        if i % 2:\n"
         "            with pytest.raises(DeviceError):\n"
         f"                {BREAKER_CALL}\n"
         "            continue\n"
         f"        got = {BREAKER_CALL}\n"),
        # test_device_batch_fn_covered_by_breaker
        tm.NO_PALLAS,
        tm.c1("np.asarray(fn(pubs, msgs, sigs))"),
    ], ("cfg.crypto.batch_fn",)),
}

CASES = []
for _name, (_subs, _cpu) in MODULES.items():
    _mod = tm.load(_name, _subs, cpu=_cpu)
    CASES += tm.param_cases(_mod, tm.module_tests(_mod))


@pytest.mark.parametrize("mod,name,args", CASES)
def test_parity_host(mod, name, args, request):
    tm.run(mod, name, request, args=args)
