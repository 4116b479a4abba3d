"""tests/test_simnet.py on the port (tests/torch_mirror.py): the simnet's
deterministic adversarial scenarios (partitions, an equivocator, a
garbage signer, a light-client attack, a WAL crash and restart, the
gateway's forged headers, the flush, height, peer and incident ledgers
replaying byte-identically), with the same bodies and assertions, on the
port's Simnet with every node on device="cpu" over a host verify plane.
Also the simnet trace of tests/test_tracing.py and the election rule of
tests/test_warmer.py on the port's simnet."""
import pytest

import torch_mirror as tm

pytestmark = pytest.mark.simnet

NAMES = [
    "test_quick_consensus_no_faults",
    "test_determinism_same_seed_same_chain",
    "test_template_packing_determinism_vs_legacy",
    "test_device_stamping_toggle_determinism",
    "test_partition_minority_stalls_then_catches_up",
    "test_equivocator_lands_in_committed_evidence",
    "test_garbage_signer_does_not_poison_verify_plane",
    "test_flush_ledger_deterministic_under_simnet",
    "test_flush_ledger_deterministic_with_deck_enabled",
    "test_height_ledger_deterministic_under_simnet",
    "test_peer_ledger_partition_visible_and_deterministic",
    "test_incident_stream_deterministic_under_simnet",
    "test_failure_blob_carries_incident_and_height_tails",
    "test_light_client_attack_evidence_committed",
    "test_failpoint_crash_and_wal_recovery",
    "test_failure_carries_replay_blob",
    "test_failure_carries_flush_ledger_tail",
    "test_stale_ledger_tail_skipped",
    "test_gateway_forged_header_scenario",
]
# test_simnet.py imports Simnet inside a parenthesised list. The
# incident scenario runs host nodes with no plane mounted
# (tm.port_host_simnet), as the JAX scenario runs no plane: its two runs'
# snapshots carry the global plane's flush tail and counters, which a
# plane shared by both runs would advance between them.
PORT = tm.load("test_simnet.py", [
    ("from cometbft_tpu_torch.simnet import (\n    Simnet,\n",
     "from torch_mirror import port_host_simnet\n"
     "from torch_mirror import port_simnet as Simnet\n"
     "from cometbft_tpu_torch.simnet import (\n"),
    ("            with Simnet(4, seed=71, basedir=str(tmp_path / tag)) "
     "as sim:\n",
     "            with port_host_simnet(4, seed=71,\n"
     "                                  basedir=str(tmp_path / tag)) "
     "as sim:\n")])


NO_PLANE = {"test_incident_stream_deterministic_under_simnet",
            "test_simnet_trace_byte_identical"}


@pytest.mark.parametrize("mod,name", tm.cases(PORT, NAMES))
def test_simnet(mod, name, request):
    tm.run(mod, name, request, plane=name not in NO_PLANE)


# the trace scenario runs host nodes with no plane too: a plane shared
# by its two runs would number their flushes differently
OTHERS = (tm.cases(tm.load("test_tracing.py", [tm.HOST_SIMNET]),
                   ["test_simnet_trace_byte_identical"])
          + tm.cases(tm.load("test_warmer.py"),
                     ["test_proportional_election_deterministic_bounded_churn"]))


@pytest.mark.parametrize("mod,name", OTHERS)
def test_simnet_elsewhere(mod, name, request):
    tm.run(mod, name, request, plane=name not in NO_PLANE)
