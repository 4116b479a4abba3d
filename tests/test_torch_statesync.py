"""tests/test_chunks.py, tests/test_statesync.py and
tests/test_statesync_recovery.py on the port (tests/torch_mirror.py):
the chunk queue and fetcher with its cache directory, the syncer against
tampered snapshots and dead or lying providers, the serve gate that sheds
with PlaneOverloaded's retry hint, and a node that statesyncs over p2p
(its light client reads node 0 over the port's RPC server through
rpc.client.light_provider). The port's nodes run on device="cpu" over a
host verify plane."""
import pytest

import torch_mirror as tm

CHUNKS = [
    "test_allocate_add_done_basics",
    "test_reclaim_expired_frees_hung_slot_on_ledger_clock",
    "test_hung_provider_does_not_stall_sync",
    "test_punish_to_drop_lifecycle",
    "test_fetch_failpoint_drives_punish_path",
    "test_cache_dir_roundtrip_survives_restart",
    "test_multi_provider_hammer_exact_accounting",
]
STATESYNC = [
    "test_syncer_rejects_tampered_snapshot",
    "test_chunk_engine_corrupt_and_slow_providers",
    "test_chunk_engine_all_providers_dead",
    "test_chunk_cache_survives_restart",
    "test_statesync_node_joins_over_p2p",
]
RECOVERY = [
    "test_kill_at_every_fetch_resumes_from_cache",
    "test_serve_gate_sheds_with_exact_retry_hint",
    "test_serve_gate_peer_table_is_bounded",
    "test_reactor_serves_proofs_then_sheds_with_hint",
    "test_reactor_snapshot_offers_carry_merkle_root",
    "test_snapshot_serve_failpoint_faults_the_serving_seam",
    "test_fetch_chunk_honors_shed_hint_then_succeeds",
    "test_fetch_chunk_rejects_bad_proof",
    "test_archive_retention_is_bounded",
]
PARAMS = (tm.cases(tm.load("test_chunks.py"), CHUNKS)
          + tm.cases(tm.load("test_statesync.py"), STATESYNC)
          + tm.cases(tm.load("test_statesync_recovery.py"), RECOVERY))


@pytest.mark.parametrize("mod,name", PARAMS)
def test_statesync(mod, name, request):
    tm.run(mod, name, request)
