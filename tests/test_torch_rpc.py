"""tests/test_rpc.py on the port (tests/torch_mirror.py): the query
language and pubsub, the core routes over HTTP (GET and POST), route
parity, tx proofs and verified abci_query, a light client syncing over
RPC, WebSocket subscriptions, tx search, pruning and the unsafe routes,
each against the port's RPC server over a port node on a host verify
plane."""
import pytest

import torch_mirror as tm

NAMES = [
    "test_query_language",
    "test_pubsub_drop_on_full",
    "test_rpc_core_routes",
    "test_query_range_comparisons",
    "test_rpc_route_parity",
    "test_tx_prove_and_verified_abci_query",
    "test_light_client_syncs_over_rpc",
    "test_websocket_subscription",
    "test_tx_indexer_and_search",
    "test_pruner_retention",
    "test_unsafe_routes_gated_and_working",
]
PORT = tm.load("test_rpc.py")


@pytest.mark.parametrize("mod,name", tm.cases(PORT, NAMES))
def test_rpc(mod, name, request):
    tm.run(mod, name, request)


# the dump routes of tests/test_zcatchup_smoke.py, test_ztenant_smoke.py
# and test_zcontroller_smoke.py over the port's RPC server, with their
# report diffs and fallbacks, and test_zlightgate_smoke.py's lightgate
# routes end to end (a forged claim from the port's simnet actors) and
# their errors without a gateway.
CATCHUP = [
    "test_dump_catchup_over_real_rpc",
    "test_catchup_report_diff_detects_synthetic_regression",
    "test_report_figures_from_ledger_dump",
    "test_no_jax_import",
]
TENANT = [
    "test_dump_tenants_over_real_rpc",
    "test_dump_tenants_empty_doc_fallback",
    "test_tenant_report_diff_detects_synthetic_regression",
    "test_cross_dump_hammer_during_plane_stop",
    "test_no_jax_import",
]
CONTROLLER = [
    "test_dump_controller_over_real_rpc",
    "test_incident_snapshot_carries_controller_tail",
    "test_controller_report_diff_detects_synthetic_regression",
    "test_no_jax_import",
]
DUMPS = (tm.cases(tm.load("test_zcatchup_smoke.py"), CATCHUP)
         + tm.cases(tm.load("test_ztenant_smoke.py", [tm.LOCAL_NET_NODE]),
                    TENANT)
         + tm.cases(tm.load("test_zcontroller_smoke.py",
                            [tm.LOCAL_NET_NODE]), CONTROLLER)
         + tm.cases(tm.load("test_zlightgate_smoke.py"),
                    ["test_lightgate_rpc_end_to_end",
                     "test_lightgate_routes_error_without_gateway"]))


@pytest.mark.parametrize("mod,name", DUMPS)
def test_rpc_dumps(mod, name, request):
    tm.run(mod, name, request)
