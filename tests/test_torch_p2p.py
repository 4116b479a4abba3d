"""tests/test_p2p.py on the port (tests/torch_mirror.py): the secret
connection, MConnection, the switch and its redial backoff and failpoints,
and 4 validators over TCP, a fifth node that blocksyncs and joins, a
partitioned validator that rejoins. The port's nodes run on
device="cpu" over a host verify plane."""
import pytest

import torch_mirror as tm

NAMES = [
    "test_secret_connection_roundtrip",
    "test_secret_connection_tamper_rejected",
    "test_mconnection_multiplex_and_priority",
    "test_switch_connect_and_stop_peer",
    "test_four_validators_over_tcp",
    "test_fifth_node_joins_and_catches_up",
    "test_partitioned_node_rejoins",
    "test_redial_backoff_grows_with_jitter",
    "test_redial_backoff_paces_attempts_then_recovers",
    "test_dial_and_handshake_failpoints_recover",
]
PORT = tm.load("test_p2p.py")


@pytest.mark.parametrize("mod,name", tm.cases(PORT, NAMES))
def test_p2p(mod, name, request):
    tm.run(mod, name, request)


# tests/test_part_set.py's multi-part block over TCP and tests/test_stress.py's
# switch connect/disconnect storm
PS_PORT = tm.load("test_part_set.py")
NODE_IMPORT = ("from cometbft_tpu_torch.node.node import LocalNetwork, Node\n",
               "from cometbft_tpu_torch.node.node import LocalNetwork\n"
               "from torch_mirror import port_node as Node\n")
ST_PORT = tm.load("test_stress.py", subs=[NODE_IMPORT])


@pytest.mark.parametrize("mod,name", tm.cases(
    PS_PORT, ["test_multipart_block_commits_over_tcp"])
    + tm.cases(ST_PORT, ["test_switch_connect_disconnect_storm"]))
def test_p2p_blocks_and_storm(mod, name, request):
    tm.run(mod, name, request)
