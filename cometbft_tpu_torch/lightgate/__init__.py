"""Light-client gateway: serve thousands of concurrent light clients
from one full node — coalesced skipping verification, a shared trusted
store, a verified-pair LRU, and the existing light-client-attack
evidence pipeline at the serving edge.

The port's copy of the JAX package's lightgate/: its header verification
rides the verify plane's GATEWAY lane, and without a plane the card.
"""
from cometbft_tpu_torch.lightgate.cache import CacheEntry, VerifiedLRU
from cometbft_tpu_torch.lightgate.gateway import (
    GatewayError,
    GatewayOverloaded,
    LightGateway,
    clear_global_gateway,
    gateway_batch_fn,
    global_gateway,
    last_gateway,
    node_light_provider,
    set_global_gateway,
)

__all__ = [
    "CacheEntry",
    "GatewayError",
    "GatewayOverloaded",
    "LightGateway",
    "VerifiedLRU",
    "clear_global_gateway",
    "gateway_batch_fn",
    "global_gateway",
    "last_gateway",
    "node_light_provider",
    "set_global_gateway",
]
