"""tests/test_mempool_gossip.py on the port (tests/torch_mirror.py):
ReapMaxGas, the mempool reactor's no-echo and once-a-peer gossip, a new
peer given the existing pool, and the in-process AppConns' serialisation.
and AppConns.socket's four connections to the port's ABCI socket server.
The port's mempools ride a host verify plane."""
import pytest

import torch_mirror as tm

NAMES = [
    "test_reap_max_gas",
    "test_no_echo_and_once_per_peer",
    "test_new_peer_gets_existing_pool",
    "test_app_conns_in_process_serializes",
    "test_app_conns_socket_four_connections",
]
PORT = tm.load("test_mempool_gossip.py")


@pytest.mark.parametrize("mod,name", tm.cases(PORT, NAMES))
def test_mempool_gossip(mod, name, request):
    tm.run(mod, name, request)
