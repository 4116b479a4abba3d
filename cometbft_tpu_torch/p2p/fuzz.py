"""Fault-injecting connection wrapper for p2p robustness tests.

Reference: p2p/fuzz.go (FuzzedConnection: drop/sleep probabilities over
a net.Conn, config FuzzConnConfig with ProbDropRW/ProbDropConn/
ProbSleep). Wraps any socket-like object (sendall/recv/close) with a
SEEDED RNG so failures reproduce; "start" mode begins fuzzing only
after a delay, letting handshakes complete first (fuzz.go
FuzzModeDelay).
"""
from __future__ import annotations

import random
import time
from dataclasses import dataclass

from cometbft_tpu_torch.p2p import peerledger


@dataclass
class FuzzConnConfig:
    """p2p/fuzz.go FuzzConnConfig."""

    prob_drop_rw: float = 0.01    # drop this write/read's payload
    prob_drop_conn: float = 0.0   # close the connection outright
    prob_sleep: float = 0.0       # stall before the op
    max_sleep_s: float = 0.1
    delay_start_s: float = 0.0    # FuzzModeDelay: fuzz only after this
    seed: int = 0


class FuzzedSocket:
    """Socket-like wrapper injecting drops/stalls/closes on writes and
    reads. Deterministic for a given (seed, op sequence).

    ``ledger_rec`` (a p2p/peerledger.py record) attributes every
    injected fault to the fuzzer instead of the network: a chaos run's
    /dump_peers shows ``inj_drops``/``inj_delays`` on the fuzzed peer,
    so the operator reading the ledger knows the packet loss was
    scheduled, not organic."""

    def __init__(self, sock, config: FuzzConnConfig,
                 ledger_rec=None):
        self._sock = sock
        self.config = config
        self._rec = ledger_rec if ledger_rec is not None \
            else peerledger.detached_record("fuzz")
        self._rng = random.Random(config.seed)
        self._born = time.monotonic()
        self._dead = False

    # -- fault machinery ---------------------------------------------------

    def _active(self) -> bool:
        return (time.monotonic() - self._born) >= \
            self.config.delay_start_s

    def _fuzz(self) -> bool:
        """Apply one fault decision; True = drop the payload."""
        if not self._active():
            return False
        c, r = self.config, self._rng
        if c.prob_drop_conn and r.random() < c.prob_drop_conn:
            peerledger.note_inj_drop(self._rec)
            self.close()
            raise OSError("fuzz: connection dropped")
        if c.prob_sleep and r.random() < c.prob_sleep:
            peerledger.note_inj_delay(self._rec)
            time.sleep(r.uniform(0, c.max_sleep_s))
        if c.prob_drop_rw and r.random() < c.prob_drop_rw:
            peerledger.note_inj_drop(self._rec)
            return True
        return False

    # -- socket surface ----------------------------------------------------

    def sendall(self, data: bytes) -> None:
        if self._dead:
            raise OSError("fuzz: closed")
        if self._fuzz():
            return  # write silently dropped (fuzz.go Write drop arm)
        self._sock.sendall(data)

    def recv(self, n: int) -> bytes:
        if self._dead:
            raise OSError("fuzz: closed")
        data = self._sock.recv(n)
        if data and self._fuzz():
            return self.recv(n)  # this read's payload vanishes
        return data

    def close(self) -> None:
        self._dead = True
        try:
            self._sock.close()
        except OSError:
            pass

    def settimeout(self, t) -> None:
        self._sock.settimeout(t)

    def fileno(self) -> int:
        return self._sock.fileno()

    def __getattr__(self, name):
        return getattr(self._sock, name)
