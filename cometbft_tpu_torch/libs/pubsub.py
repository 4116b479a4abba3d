"""Query-filtered publish/subscribe bus.

Reference: libs/pubsub (Server with query-matched subscriptions; the
query language lives in libs/pubsub/query). Grammar: conditions joined
by AND over event tags with =, CONTAINS, EXISTS and the numeric range
comparisons <, >, <=, >= — `tm.event='NewBlock' AND tx.height>5`.
Range comparisons coerce both sides to numbers (the reference compares
int64/float64 the same way, query/query.go conditionXX); a non-numeric
tag value simply doesn't match.

The port's copy of the JAX package's libs/pubsub.py.
"""
from __future__ import annotations

import queue
import re
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional


class QueryError(Exception):
    pass


_COND = re.compile(
    r"\s*([\w.]+)\s*(<=|>=|<|>|=|CONTAINS|EXISTS)\s*"
    r"('(?:[^']*)'|\"(?:[^\"]*)\"|\S+)?\s*$"
)

RANGE_OPS = ("<", ">", "<=", ">=")

CMP = {
    "<": lambda a, b: a < b,
    ">": lambda a, b: a > b,
    "<=": lambda a, b: a <= b,
    ">=": lambda a, b: a >= b,
}


def _num(s):
    # ints first, exactly: int64 heights/amounts above 2^53 lose
    # precision as floats and would phantom-match neighbors (the
    # reference compares int64s exactly, query/query.go). Python
    # compares int-vs-float exactly too, so mixed conditions stay safe.
    try:
        return int(s)
    except (TypeError, ValueError):
        pass
    try:
        return float(s)
    except (TypeError, ValueError):
        return None


@dataclass(frozen=True)
class Condition:
    key: str
    op: str
    value: Optional[str]


class Query:
    """AND-joined conditions over string event tags (libs/pubsub/query)."""

    def __init__(self, s: str):
        self.source = s
        self.conditions: List[Condition] = []
        for part in s.split(" AND "):
            part = part.strip()
            if not part:
                continue
            m = _COND.match(part)
            if not m:
                raise QueryError(f"bad query condition {part!r}")
            key, op, raw = m.group(1), m.group(2), m.group(3)
            if op == "EXISTS":
                self.conditions.append(Condition(key, op, None))
                continue
            if raw is None:
                raise QueryError(f"missing value in {part!r}")
            if raw[0] in "'\"" and raw[-1] == raw[0]:
                raw = raw[1:-1]
            if op in RANGE_OPS and _num(raw) is None:
                raise QueryError(
                    f"range comparison needs a numeric value: {part!r}"
                )
            self.conditions.append(Condition(key, op, raw))

    def matches(self, tags: Dict[str, List[str]]) -> bool:
        for c in self.conditions:
            vals = tags.get(c.key)
            if vals is None:
                return False
            if c.op == "EXISTS":
                continue
            if c.op == "=":
                if c.value not in vals:
                    return False
            elif c.op == "CONTAINS":
                if not any(c.value in v for v in vals):
                    return False
            elif c.op in RANGE_OPS:
                want = _num(c.value)
                cmp = CMP[c.op]
                if not any(
                    got is not None and cmp(got, want)
                    for got in map(_num, vals)
                ):
                    return False
        return True

    def __repr__(self):
        return f"Query({self.source!r})"


@dataclass
class Message:
    data: object
    tags: Dict[str, List[str]] = field(default_factory=dict)


class Subscription:
    def __init__(self, query: Query, capacity: int = 100):
        self.query = query
        self.queue: "queue.Queue[Message]" = queue.Queue(maxsize=capacity)
        self.cancelled = False

    def next(self, timeout: Optional[float] = None) -> Optional[Message]:
        try:
            return self.queue.get(timeout=timeout)
        except queue.Empty:
            return None


class PubSub:
    """The bus (libs/pubsub.Server): thread-safe, drop-on-full per
    subscriber (slow consumers must not stall consensus)."""

    def __init__(self):
        self._subs: Dict[tuple, Subscription] = {}
        self._lock = threading.Lock()

    def subscribe(self, subscriber: str, query: str,
                  capacity: int = 100) -> Subscription:
        sub = Subscription(Query(query), capacity)
        with self._lock:
            self._subs[(subscriber, query)] = sub
        return sub

    def unsubscribe(self, subscriber: str, query: str) -> None:
        with self._lock:
            sub = self._subs.pop((subscriber, query), None)
        if sub:
            sub.cancelled = True

    def unsubscribe_all(self, subscriber: str) -> None:
        with self._lock:
            keys = [k for k in self._subs if k[0] == subscriber]
            for k in keys:
                self._subs.pop(k).cancelled = True

    def publish(self, data, tags: Dict[str, List[str]]) -> None:
        msg = Message(data, tags)
        with self._lock:
            subs = list(self._subs.values())
        for sub in subs:
            if sub.query.matches(tags):
                try:
                    sub.queue.put_nowait(msg)
                except queue.Full:
                    pass  # drop for slow consumers (reference buffers+drops)
