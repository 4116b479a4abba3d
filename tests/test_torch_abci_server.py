"""The app and the signer out of process, on the port (tests/torch_mirror.py):
tests/test_abci_socket.py (the socket server and client, a node over
them), tests/test_abci_grpc.py (the gRPC server and client, a node over a
gRPC kvstore served by `python -m cometbft_tpu_torch abci kvstore`),
tests/test_remote_signer.py (the signer endpoint and server, a validator
signing through them) and tests/test_psql_sink.py (the event sink's schema
over sqlite)."""
import pytest

import torch_mirror as tm

SOCKET = ["test_roundtrip_methods", "test_node_runs_over_socket_app"]
GRPC = [
    "test_roundtrip_methods",
    "test_snapshot_family_roundtrip",
    "test_app_error_surfaces_as_exception",
    "test_concurrent_calls_multiplex",
    "test_node_runs_over_grpc_app_subprocess",
]
SIGNER = ["test_sign_and_double_sign_protection",
          "test_validator_runs_with_remote_signer"]
PSQL = [
    "test_tx_events_schema_parity",
    "test_block_events_view_and_search_unsupported",
    "test_indexer_service_feeds_extra_sink",
]
PARAMS = (tm.cases(tm.load("test_abci_socket.py"), SOCKET)
          + tm.cases(tm.load("test_abci_grpc.py"), GRPC)
          + tm.cases(tm.load("test_remote_signer.py"), SIGNER)
          + tm.cases(tm.load("test_psql_sink.py"), PSQL))


@pytest.mark.parametrize("mod,name", PARAMS)
def test_abci_server(mod, name, request):
    tm.run(mod, name, request)
