"""MConnection: channel-multiplexed connection with priorities, ping/pong
and flow control.

Reference: p2p/conn/connection.go:81 — sendRoutine/recvRoutine (:238-239),
per-channel priority queues with sendQueueCapacity, msg packets of
maxPacketMsgPayloadSize with EOF marker, ping/pong keepalive, flowrate
throttling. Channel descriptors are declared per reactor (e.g.
consensus/reactor.go:154-190).

Wire format (self-defined): each packet is one SecretConnection message:
  PING: b"P"; PONG: b"O"
  MSG:  b"M" + chan_id(1) + eof(1) + payload
Flow control is a token bucket on bytes/sec applied in the send routine
(the libs/flowrate analog)."""
from __future__ import annotations

import logging
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from cometbft_tpu_torch.p2p import peerledger

_log = logging.getLogger(__name__)

MAX_PACKET_PAYLOAD = 1400     # connection.go maxPacketMsgPayloadSize
PING_INTERVAL = 10.0
SEND_RATE = 5_120_000         # config default send_rate bytes/s
RECV_RATE = 5_120_000
SEND_TIMEOUT = 10.0           # blocking Send's queue.Full deadline
# rate limit for full-queue warnings: a starved peer must be VISIBLE in
# the log without a 2000-deep queue turning it into a log flood
_FULL_LOG_INTERVAL = 1.0


@dataclass
class ChannelDescriptor:
    """connection.go ChannelDescriptor."""

    chan_id: int
    priority: int = 1
    send_queue_capacity: int = 100
    recv_message_capacity: int = 22 * 1024 * 1024


@dataclass
class _Channel:
    desc: ChannelDescriptor
    send_queue: "queue.Queue" = None
    recv_buf: bytes = b""
    recently_sent: int = 0

    def __post_init__(self):
        self.send_queue = queue.Queue(maxsize=self.desc.send_queue_capacity)


class MConnection:
    """on_receive(chan_id, msg_bytes) fires on the recv thread; on_error
    fires once when either routine dies."""

    def __init__(
        self,
        conn,  # SecretConnection (or any object with write_msg/read_msg)
        channels: List[ChannelDescriptor],
        on_receive: Callable[[int, bytes], None],
        on_error: Optional[Callable[[Exception], None]] = None,
        send_rate: int = SEND_RATE,
        ledger_rec: Optional[list] = None,
    ):
        self.conn = conn
        self.channels: Dict[int, _Channel] = {
            d.chan_id: _Channel(d) for d in channels
        }
        self.on_receive = on_receive
        self.on_error = on_error or (lambda e: None)
        self.send_rate = send_rate
        # the gossip-observatory seam (p2p/peerledger.py): the Switch
        # hands in the per-peer record; bare MConnections get a
        # detached one so the instrumentation path is unconditional
        self._led = ledger_rec if ledger_rec is not None \
            else peerledger.detached_record()
        self._last_full_log = 0.0
        self._send_wake = threading.Event()
        self._stop = threading.Event()
        self._err_once = threading.Lock()
        self._errored = False
        self._threads: List[threading.Thread] = []
        self._last_recv = time.time()

    def start(self) -> None:
        for fn, name in ((self._send_routine, "mconn-send"),
                         (self._recv_routine, "mconn-recv")):
            t = threading.Thread(target=fn, daemon=True, name=name)
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        self._stop.set()
        self._send_wake.set()
        try:
            self.conn._stream.close()
        except Exception:  # noqa: BLE001
            pass

    # -- sending -----------------------------------------------------------

    def send(self, chan_id: int, msg: bytes, block: bool = True) -> bool:
        """Queue msg on the channel (Send/TrySend, connection.go:268).

        A False from a FULL queue was previously indistinguishable from
        a stopped conn: now every full-queue outcome increments the
        peer ledger's counters (blocked_puts for a blocking send that
        had to wait, full_drops for a drop) and logs rate-limited — a
        starving peer is visible in /dump_peers and the log, not just
        as silently missing gossip."""
        ch = self.channels.get(chan_id)
        if ch is None or self._stop.is_set():
            return False
        try:
            ch.send_queue.put_nowait(msg)
        except queue.Full:
            if not block:
                peerledger.note_full_drop(self._led)
                self._log_full(chan_id)
                return False
            # blocking path: the queue is full RIGHT NOW — count the
            # stall before waiting out the timeout
            peerledger.note_blocked_put(self._led)
            try:
                ch.send_queue.put(msg, timeout=SEND_TIMEOUT)
            except queue.Full:
                peerledger.note_full_drop(self._led)
                self._log_full(chan_id, timed_out=True)
                return False
        peerledger.note_queue_depth(self._led, ch.send_queue.qsize())
        self._send_wake.set()
        return True

    def _log_full(self, chan_id: int, timed_out: bool = False) -> None:
        now = time.monotonic()
        if now - self._last_full_log < _FULL_LOG_INTERVAL:
            return
        self._last_full_log = now
        _log.warning(
            "peer %s send queue full on %#x (%s; %d drops so far)",
            self._led[0], chan_id,
            "blocking send timed out" if timed_out else "dropped",
            self._led[peerledger._P_FULLDROP])

    def _pick_channel(self) -> Optional[_Channel]:
        """Least (recently_sent / priority) among channels with queued
        data (connection.go sendPacketMsg's least-ratio rule). A dead
        ``and not ch.recv_buf: pass`` branch used to sit here — recv_buf
        is the RECEIVE reassembly buffer and has no bearing on send
        eligibility."""
        best, best_ratio = None, None
        for ch in self.channels.values():
            if ch.send_queue.empty():
                continue
            ratio = ch.recently_sent / max(1, ch.desc.priority)
            if best is None or ratio < best_ratio:
                best, best_ratio = ch, ratio
        return best

    def _send_routine(self) -> None:
        budget = float(MAX_PACKET_PAYLOAD)
        last = time.time()
        last_ping = time.time()
        try:
            while not self._stop.is_set():
                now = time.time()
                budget = min(
                    self.send_rate, budget + (now - last) * self.send_rate
                )
                last = now
                if now - last_ping > PING_INTERVAL:
                    # stamp BEFORE the write so the measured RTT covers
                    # the wire round trip, not just our recv latency
                    peerledger.note_ping_sent(self._led)
                    self.conn.write_msg(b"P")
                    last_ping = now
                ch = self._pick_channel()
                if ch is None:
                    self._send_wake.wait(0.05)
                    self._send_wake.clear()
                    continue
                if budget <= 0:
                    # flow-control throttle: the token bucket is dry
                    peerledger.note_throttle(self._led, 5.0)
                    time.sleep(0.005)
                    continue
                msg = ch.send_queue.get_nowait()
                peerledger.note_queue_depth(self._led,
                                            ch.send_queue.qsize())
                # split into packets with EOF marker
                off = 0
                wire_bytes = 0
                while True:
                    part = msg[off:off + MAX_PACKET_PAYLOAD]
                    off += len(part)
                    eof = b"\x01" if off >= len(msg) else b"\x00"
                    pkt = b"M" + bytes([ch.desc.chan_id]) + eof + part
                    self.conn.write_msg(pkt)
                    ch.recently_sent += len(pkt)
                    wire_bytes += len(pkt)
                    budget -= len(pkt)
                    if eof == b"\x01":
                        break
                peerledger.note_sent(self._led, ch.desc.chan_id,
                                     wire_bytes)
                # decay so quiet channels regain priority
                for c in self.channels.values():
                    c.recently_sent = int(c.recently_sent * 0.8)
        except Exception as e:  # noqa: BLE001
            self._fire_error(e)

    # -- receiving ---------------------------------------------------------

    def _recv_routine(self) -> None:
        try:
            while not self._stop.is_set():
                pkt = self.conn.read_msg()
                self._last_recv = time.time()
                if not pkt:
                    continue
                kind = pkt[:1]
                if kind == b"P":
                    self.conn.write_msg(b"O")
                elif kind == b"O":
                    # pong: stamp the RTT against the matching ping
                    # (previously nothing measured it — the ledger's
                    # per-peer rtt_ms column is this)
                    peerledger.note_pong(self._led)
                elif kind == b"M":
                    chan_id, eof = pkt[1], pkt[2]
                    ch = self.channels.get(chan_id)
                    if ch is None:
                        raise ValueError(f"unknown channel {chan_id}")
                    ch.recv_buf += pkt[3:]
                    if len(ch.recv_buf) > ch.desc.recv_message_capacity:
                        raise ValueError("recv message exceeds capacity")
                    peerledger.note_recv(self._led, chan_id, len(pkt),
                                         eof=eof == 1)
                    if eof == 1:
                        msg, ch.recv_buf = ch.recv_buf, b""
                        self.on_receive(chan_id, msg)
                else:
                    raise ValueError(f"bad packet type {kind!r}")
        except Exception as e:  # noqa: BLE001
            self._fire_error(e)

    def _fire_error(self, e: Exception) -> None:
        with self._err_once:
            if self._errored:
                return
            self._errored = True
        if not self._stop.is_set():
            self.on_error(e)
