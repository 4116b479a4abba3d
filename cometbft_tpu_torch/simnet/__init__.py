"""Byzantine simnet: deterministic in-process adversarial network
simulation (see simnet/core.py for the architecture)."""
from cometbft_tpu_torch.simnet.core import Link, SimNetwork, SimNode
from cometbft_tpu_torch.simnet.harness import Simnet, SimnetFailure
from cometbft_tpu_torch.simnet.schedule import (
    ScheduleError,
    random_schedule,
    schedule_from_json,
    schedule_to_json,
    validate_schedule,
)

__all__ = [
    "Link", "SimNetwork", "SimNode", "Simnet", "SimnetFailure",
    "ScheduleError", "random_schedule", "schedule_from_json",
    "schedule_to_json", "validate_schedule",
]
