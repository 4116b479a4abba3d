"""tests/test_zpeer_smoke.py on the port (tests/torch_mirror.py): the
peer ledger's records over a real Switch pair on TCP, the MConnection's
full queue, the fuzzer's fault attribution, the peer_starvation incident,
/dump_peers against a stopping switch, the peer_report diff and the
ledger's per-message budget (the port's copy of bench.py's helper over
the port's peer ledger) and /dump_peers over the port's RPC server."""
import pytest

import torch_mirror as tm

NAMES = [
    "test_record_shape_and_seam",
    "test_summary_totals_monotone_across_ring_eviction",
    "test_switch_pair_traffic_rtt_and_drop_attribution",
    "test_mconnection_full_queue_observable",
    "test_fuzzed_socket_attributes_injected_faults",
    "test_peer_starvation_incident_trigger",
    "test_dump_peers_concurrent_with_switch_stop",
    "test_peer_report_diff_detects_synthetic_regression",
    "test_peer_ledger_message_budget",
    "test_dump_peers_over_real_rpc",
    "test_no_jax_import",
]
PORT = tm.load("test_zpeer_smoke.py", subs=[
    tm.LOCAL_NET_NODE,
    ("    import bench\n", "    bench = tm_bench()\n"),
    ("import pytest\n", "import pytest\n\nfrom torch_mirror import port_bench as tm_bench\n")])


@pytest.mark.parametrize("mod,name", tm.cases(PORT, NAMES))
def test_zpeer_smoke(mod, name, request):
    tm.run(mod, name, request)
