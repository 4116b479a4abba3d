"""EventBus: typed event publication over the pubsub bus.

Reference: types/event_bus.go:39 (EventBus wraps libs/pubsub; typed
publishers PublishEventNewBlock/Tx/Vote/ValidatorSetUpdates tag events
with tm.event + composite ABCI event tags), types/events.go (event type
strings).

The port's copy of the JAX package's types/event_bus.py.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from cometbft_tpu_torch.libs.pubsub import PubSub, Subscription

# types/events.go event strings
EVENT_NEW_BLOCK = "NewBlock"
EVENT_NEW_BLOCK_HEADER = "NewBlockHeader"
EVENT_TX = "Tx"
EVENT_VOTE = "Vote"
EVENT_NEW_ROUND = "NewRound"
EVENT_VALIDATOR_SET_UPDATES = "ValidatorSetUpdates"

EVENT_TYPE_KEY = "tm.event"
TX_HASH_KEY = "tx.hash"
TX_HEIGHT_KEY = "tx.height"


class EventBus:
    def __init__(self):
        self.pubsub = PubSub()

    # -- subscription ------------------------------------------------------

    def subscribe(self, subscriber: str, query: str,
                  capacity: int = 100) -> Subscription:
        return self.pubsub.subscribe(subscriber, query, capacity)

    def unsubscribe(self, subscriber: str, query: str) -> None:
        self.pubsub.unsubscribe(subscriber, query)

    def unsubscribe_all(self, subscriber: str) -> None:
        self.pubsub.unsubscribe_all(subscriber)

    # -- typed publishers (event_bus.go:118-280) ---------------------------

    def _publish(self, event_type: str, data,
                 extra_tags: Optional[Dict[str, List[str]]] = None) -> None:
        tags = {EVENT_TYPE_KEY: [event_type]}
        if extra_tags:
            for k, v in extra_tags.items():
                tags.setdefault(k, []).extend(v)
        self.pubsub.publish(data, tags)

    def publish_new_block(self, block, result=None) -> None:
        self._publish(EVENT_NEW_BLOCK, {"block": block, "result": result})

    def publish_new_block_header(self, header) -> None:
        self._publish(EVENT_NEW_BLOCK_HEADER, {"header": header})

    def publish_tx(self, height: int, tx: bytes, result) -> None:
        import hashlib

        self._publish(
            EVENT_TX,
            {"height": height, "tx": tx, "result": result},
            {
                TX_HASH_KEY: [hashlib.sha256(tx).hexdigest().upper()],
                TX_HEIGHT_KEY: [str(height)],
            },
        )

    def publish_vote(self, vote) -> None:
        self._publish(EVENT_VOTE, {"vote": vote})

    def publish_validator_set_updates(self, updates) -> None:
        self._publish(EVENT_VALIDATOR_SET_UPDATES, {"updates": updates})
