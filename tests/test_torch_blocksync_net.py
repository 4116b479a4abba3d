"""tests/test_blocksync.py's catch-up, pool, reactor and ban tests
(:103-249) on the port (tests/torch_mirror.py). The port's reactor
verifies each run in a StreamVerifier(device="cpu"): these chains have
one validator, under its min_device_sigs rows, so the runs verify on the
host, as the JAX package's do. The chain is made by a port node on
device="cpu" over a host verify plane."""
import pytest

import torch_mirror as tm

NAMES = [
    "test_catchup_from_one_peer",
    "test_pool_request_timeout_reassigns_and_drops_peer",
    "test_sync_completes_with_flaky_requests_and_deliveries",
    "test_transient_local_process_fault_retries_without_ban",
    "test_bad_peer_banned_good_peer_completes",
]
PORT = tm.load("test_blocksync.py", subs=[
    ("StreamVerifier(use_pallas=False)", 'StreamVerifier(device="cpu")')])


@pytest.mark.parametrize("mod,name", tm.cases(PORT, NAMES))
def test_blocksync_net(mod, name, request):
    tm.run(mod, name, request)
