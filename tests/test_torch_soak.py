"""tests/test_soak.py on the port (tests/torch_mirror.py): the chaos soak
(a signed flood through the BULK lane while a partition, a kill and
restart, garbage votes and a verify-plane dispatch fault fire), the
epoch-churn soak over a 32-member passive validator tail, the
commit-stall incident replay, the flood reaching blocks and the
self-tuning controller's diurnal arms, with the same bodies and
assertions, on the port's Simnet with every node on device="cpu" over
the port's host verify plane (use_device=False, the JAX semantics: a
dispatch fault answers from the host). The 10k-validator churn run is
`slow` in the JAX file and runs on the card in chip_smoke.py phase 21."""
import pytest

import torch_mirror as tm

pytestmark = pytest.mark.simnet

NAMES = [
    "test_chaos_soak_survives_flood",
    "test_chaos_soak_vote_latency_bounded",
    "test_chaos_soak_deterministic",
    "test_churn_soak_rotation_survives_chaos",
    "test_churn_soak_deterministic",
    "test_chaos_soak_commit_stall_incident_replays",
    "test_flood_reaches_blocks",
    "test_diurnal_controller_holds_slo",
    "test_diurnal_static_arms_fail",
    "test_diurnal_decision_stream_deterministic",
]
PORT = tm.load("test_soak.py")


@pytest.mark.parametrize("mod,name", tm.cases(PORT, NAMES))
def test_soak(mod, name, request):
    tm.run(mod, name, request)
