"""tests/test_bootstrap_soak.py on the port (tests/torch_mirror.py): a
simnet node whose disk is lost bootstraps from the donors' snapshots and
catch-up, then rejoins live under a flood and a partition, with the same
bodies and assertions, on the port's Simnet (device="cpu") over the
port's host verify plane."""
import pytest

import torch_mirror as tm

pytestmark = pytest.mark.simnet

NAMES = [
    "test_killed_node_bootstraps_to_live",
    "test_donor_serving_sheds_are_explicit_and_consensus_clean",
    "test_catchup_resumes_mid_bootstrap_reverifying_zero",
    "test_bootstrap_replays_byte_identical",
]
PORT = tm.load("test_bootstrap_soak.py")


@pytest.mark.parametrize("mod,name", tm.cases(PORT, NAMES))
def test_bootstrap_soak(mod, name, request):
    tm.run(mod, name, request)
