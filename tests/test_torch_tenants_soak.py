"""tests/test_tenants_soak.py on the port (tests/torch_mirror.py): K
chain groups of the port's Simnet (device="cpu") share one host verify
plane while chaos and a signed flood ride one of them; cross-tenant
coalescing, tenant quotas, a noisy neighbor, byte-identical replay and a
group's commits against the same chain run solo, with the same bodies
and assertions."""
import pytest

import torch_mirror as tm

pytestmark = pytest.mark.simnet

NAMES = [
    "test_multichain_one_plane_coalesces",
    "test_multichain_flood_is_answered_and_consensus_unshed",
    "test_multichain_deterministic_replay",
    "test_shared_plane_group_matches_solo_run",
    "test_noisy_neighbor_is_contained",
]
PORT = tm.load("test_tenants_soak.py")


@pytest.mark.parametrize("mod,name", tm.cases(PORT, NAMES))
def test_tenants_soak(mod, name, request):
    tm.run(mod, name, request)
