"""tests/test_fuzz.py on the port (tests/torch_mirror.py): secret
connection frame corruption, handshake garbage, CheckTx fuzz and the
fault-injecting socket (p2p/fuzz.py) and garbage bodies and query
strings against the port's RPC server."""
import pytest

import torch_mirror as tm

NAMES = [
    "test_secret_connection_frame_corruption_never_panics",
    "test_handshake_garbage_rejected",
    "test_mempool_checktx_fuzz",
    "test_fuzzed_socket_drops_are_survivable",
    "test_rpc_server_fuzz",
]
PORT = tm.load("test_fuzz.py")


@pytest.mark.parametrize("mod,name", tm.cases(PORT, NAMES))
def test_fuzz(mod, name, request):
    tm.run(mod, name, request)
