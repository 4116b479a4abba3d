"""tests/test_zheight_smoke.py on the port (tests/torch_mirror.py): the
height ledger's records over a committing LocalNetwork of port nodes,
/dump_heights and /dump_incidents over the port's RPC server (and
against a stopping node), incident triggers and snapshots, the
height_report diff, late-signer attribution and the ledger's per-step
budget (the port's copy of bench.py's helper over the port's ledger)."""
import pytest

import torch_mirror as tm

NAMES = [
    "test_height_ledger_record_shape",
    "test_dump_routes_serve_after_stop",
    "test_dump_routes_concurrent_with_stop",
    "test_dump_heights_over_real_rpc",
    "test_incident_failpoint_trigger_freezes_snapshot",
    "test_incident_commit_stall_and_round_escalation_triggers",
    "test_shed_storm_window_semantics",
    "test_watchdog_ticker_detects_total_wedge",
    "test_height_report_diff_detects_synthetic_regression",
    "test_late_signer_attribution_math",
    "test_late_signer_split_on_live_network",
    "test_height_ledger_step_bookkeeping_budget",
    "test_no_jax_import",
]
# node 0 owns the test's plane and stops it: stop it last, or node 1's
# votes fall to the plain kernel (seconds a vote on one core) and outlive
# the test
STOP_ORDER = (
    "        # stop everything WHILE the hammer runs\n"
    "        for n in nodes:\n",
    "        # stop everything WHILE the hammer runs\n"
    "        for n in reversed(nodes):\n")
PORT = tm.load("test_zheight_smoke.py", subs=[
    tm.LOCAL_NET_NODE, STOP_ORDER,
    ("    import bench\n", "    bench = tm_bench()\n"),
    ("import pytest\n",
     "import pytest\n\nfrom torch_mirror import port_bench as tm_bench\n")])


@pytest.mark.parametrize("mod,name", tm.cases(PORT, NAMES))
def test_zheight_smoke(mod, name, request):
    tm.run(mod, name, request)
