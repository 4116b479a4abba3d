"""AppConns: the four logical ABCI connections.

Reference: proxy/multi_app_conn.go — consensus, mempool, query, and
snapshot each get their own logical connection to the application so a
slow CheckTx cannot serialize behind FinalizeBlock at the CLIENT; the
in-process application itself is still guarded by one mutex
(abci/client/local_client.go — ABCI apps need not be concurrency-safe).

Two constructions:
  * in_process(app): four facades over the same Application sharing one
    RLock (local client semantics).
  * socket(host, port): four independent socket clients to one ABCI
    server — requests on different conns pipeline on the wire; the
    server's own app lock provides the final serialization.

The port's copy of the JAX package's abci/proxy.py.
"""
from __future__ import annotations

import threading

from cometbft_tpu_torch.abci import types as abci

_FORWARDED = (
    "info", "init_chain", "check_tx", "prepare_proposal",
    "process_proposal", "finalize_block", "commit", "query",
    "extend_vote", "verify_vote_extension", "list_snapshots",
    "offer_snapshot", "load_snapshot_chunk", "apply_snapshot_chunk",
)


class _LockedConn:
    """One logical connection over a shared app + mutex
    (local_client.go's global-mutex model)."""

    def __init__(self, app: abci.Application, lock: threading.RLock):
        self._app = app
        self._lock = lock

    def __getattr__(self, name):
        if name not in _FORWARDED:
            raise AttributeError(name)
        fn = getattr(self._app, name)
        lock = self._lock

        def call(*args, **kwargs):
            with lock:
                return fn(*args, **kwargs)

        return call


class AppConns:
    """proxy.AppConns: .consensus / .mempool / .query / .snapshot."""

    def __init__(self, consensus, mempool, query, snapshot):
        self.consensus = consensus
        self.mempool = mempool
        self.query = query
        self.snapshot = snapshot

    @classmethod
    def in_process(cls, app: abci.Application) -> "AppConns":
        lock = threading.RLock()
        return cls(*(_LockedConn(app, lock) for _ in range(4)))

    @classmethod
    def socket(cls, host: str, port: int, timeout: float = 30.0
               ) -> "AppConns":
        from cometbft_tpu_torch.abci.server import ABCISocketClient

        return cls(*(ABCISocketClient(host, port, timeout=timeout)
                     for _ in range(4)))

    @classmethod
    def grpc(cls, host: str, port: int, timeout: float = 30.0
             ) -> "AppConns":
        """Four logical conns over ONE multiplexed gRPC channel
        (grpc_client.go: HTTP/2 streams replace the socket client's
        per-connection ordering mutex)."""
        from cometbft_tpu_torch.abci.grpc import ABCIGRPCClient

        client = ABCIGRPCClient(host, port, timeout=timeout)
        conns = cls(client, client, client, client)
        conns._grpc_client = client
        return conns

    @classmethod
    def from_addr(cls, addr: str, timeout: float = 30.0) -> "AppConns":
        """proxy_app address -> AppConns: ``tcp://h:p`` or ``h:p``
        (socket server), ``grpc://h:p`` (gRPC server) — the
        proxy.DefaultClientCreator dispatch (proxy/client.go)."""
        scheme, sep, rest = addr.partition("://")
        if not sep:
            scheme, rest = "tcp", addr
        host, _, port = rest.rpartition(":")
        host = host or "127.0.0.1"
        if scheme == "grpc":
            return cls.grpc(host, int(port), timeout=timeout)
        if scheme in ("tcp", "socket"):
            return cls.socket(host, int(port), timeout=timeout)
        raise ValueError(f"unknown proxy_app scheme {scheme!r}")

    def close(self) -> None:
        for c in (self.consensus, self.mempool, self.query, self.snapshot):
            close = getattr(c, "close", None)
            if close is not None:
                close()
