"""The operator surface on the port (tests/torch_mirror.py):
tests/test_cli.py (config round trip, `init` + `start` serving RPC,
`testnet`, `reindex-event`, `debug dump|kill`), tests/test_tools.py
(the WAL generator, loadtime's payload and report, WAL rotation; not the
bench-history renderer, a repo script over BENCH files),
tests/test_zloadtime_smoke.py (tools/loadtime.py's smoke and open loop
with its imports pointed at the port) and tests/test_service_plane.py
(`rollback`, `compact`, the inspect server, the light proxy over the
port's RPC, the abci one-shot CLI)."""
import pytest

import torch_mirror as tm

CLI = [
    "test_config_roundtrip",
    "test_init_start_rpc",
    "test_testnet_generation",
    "test_reindex_event_rebuilds_indexes",
    "test_debug_dump_and_kill",
]
TOOLS = [
    "test_wal_generator_and_wal2json",
    "test_payload_roundtrip",
    "test_load_and_report",
    "test_wal_rotation_and_group_replay",
]
LOADTIME = ["test_loadtime_smoke_cli",
            "test_open_loop_schedule_is_not_closed_loop"]
SERVICE = [
    "test_rollback_and_restart",
    "test_compact",
    "test_inspect_server",
    "test_light_proxy",
    "test_abci_cli_oneshot",
]
PORT_LOADTIME = ("from tools import loadtime\n",
                 "from torch_mirror import port_tool\n\n"
                 "loadtime = port_tool(\"loadtime\")\n")
WAL_ON_CPU = ("generate_wal(3, dest)", "generate_wal(3, dest, device=\"cpu\")")
PARAMS = (tm.cases(tm.load("test_cli.py"), CLI)
          + tm.cases(tm.load("test_tools.py", [WAL_ON_CPU]), TOOLS)
          + tm.cases(tm.load("test_zloadtime_smoke.py", [PORT_LOADTIME]),
                     LOADTIME)
          + tm.cases(tm.load("test_service_plane.py"), SERVICE))


@pytest.mark.parametrize("mod,name", PARAMS)
def test_cli(mod, name, request):
    tm.run(mod, name, request)


# tests/test_e2e.py: testnets of `python -m cometbft_tpu_torch start`
# processes (host nodes, verifier = "cpu") driven over RPC; slow, as the
# original
E2E = ["test_e2e_basic_and_kill_restart",
       "test_e2e_perturbation_matrix",
       "test_e2e_byzantine_evidence_committed"]


@pytest.mark.slow
@pytest.mark.parametrize("mod,name", tm.cases(tm.load("test_e2e.py"), E2E))
def test_e2e(mod, name, request):
    tm.run(mod, name, request)
