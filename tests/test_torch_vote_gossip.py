"""tests/test_vote_gossip.py on the port (tests/torch_mirror.py): the
consensus reactor's lack-based vote gossip, HasVote, VoteSetMaj23 /
VoteSetBits, and a 4-validator TCP net whose duplicate deliveries stay
bounded. The port's nodes run on device="cpu" over a host verify plane."""
import pytest

import torch_mirror as tm

NAMES = [
    "test_lack_based_gossip_sends_each_vote_once",
    "test_has_vote_suppresses_resend",
    "test_maj23_answers_with_vote_set_bits",
    "test_vote_set_bits_fills_peer_bitmap",
    "test_tcp_net_converges_with_bounded_duplicates",
]
PORT = tm.load("test_vote_gossip.py")


@pytest.mark.parametrize("mod,name", tm.cases(PORT, NAMES))
def test_vote_gossip(mod, name, request):
    tm.run(mod, name, request)
