"""ABCI over gRPC: run the application out of process on HTTP/2.

Reference: abci/server/grpc_server.go + abci/client/grpc_client.go —
the third app-connection mode next to in-process and socket. The gRPC
mode's value over the socket client (which serializes every call under
one connection mutex, socket_client.go's ordering contract) is true
per-call multiplexing: HTTP/2 streams let CheckTx traffic, consensus
FinalizeBlock and snapshot serving proceed concurrently, which is why
the reference recommends it for apps that parallelize internally
(grpc_client.go:20-28).

Transport: real gRPC (grpcio) with a generic service handler — one
unary-unary method per ABCI method under the service name
``cometbft.abci.v1.ABCI``. Message bodies reuse the framed-JSON codec
of abci/server.py (base64 bytes fields); the reference's protobuf
payloads are a Go implementation detail, not a consensus encoding —
what matters is the 14-method surface, kept identical across all three
modes (abci/types.py Application).

The port's copy of the JAX package's abci/grpc.py. `grpcio` is imported
only where a server or client is built.
"""
from __future__ import annotations

import json
import threading
from concurrent import futures
from typing import Optional

from cometbft_tpu_torch.abci import types as abci
from cometbft_tpu_torch.abci.server import (
    _ARG_METHODS,
    _METHODS,
    _dec,
    _enc,
    _rebuild,
)
from cometbft_tpu_torch.libs.service import BaseService

SERVICE = "cometbft.abci.v1.ABCI"


def _ident(b: bytes) -> bytes:
    return b


class ABCIGRPCServer(BaseService):
    """abci/server/grpc_server.go: serve an Application over gRPC."""

    def __init__(self, app: abci.Application, host: str = "127.0.0.1",
                 port: int = 0, max_workers: int = 8,
                 serialize_app: bool = True):
        super().__init__("ABCIGRPCServer")
        self.app = app
        self._host, self._port = host, port
        self._max_workers = max_workers
        self._server = None
        self.addr = (host, port)
        # ABCI applications need not be concurrency-safe
        # (abci/client/local_client.go's global-mutex model; the socket
        # server holds the same lock). Requests still multiplex on the
        # wire; a thread-safe app may pass serialize_app=False to let
        # handler threads run it concurrently.
        self._app_lock = threading.RLock() if serialize_app else None

    def _handler(self, method: str):
        app = self.app

        def call(request: bytes, context) -> bytes:
            import grpc

            try:
                doc = _dec(json.loads(request.decode()))
                import contextlib

                guard = (self._app_lock if self._app_lock is not None
                         else contextlib.nullcontext())
                with guard:
                    if method in _ARG_METHODS:
                        fix = _ARG_METHODS[method][0]
                        args = doc.get("a", [])
                        if fix:
                            args = fix(args)
                        r = getattr(app, method)(*args)
                    else:
                        req_cls, _ = _METHODS[method]
                        if req_cls is None:
                            r = getattr(app, method)()
                        else:
                            r = getattr(app, method)(
                                _rebuild(req_cls, doc["q"]))
                return json.dumps(_enc(r)).encode()
            except Exception as e:  # noqa: BLE001 - app errors -> status
                context.abort(grpc.StatusCode.INTERNAL,
                              f"abci app error: {e}")

        return call

    def on_start(self) -> None:
        import grpc

        self._server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=self._max_workers)
        )
        handlers = {}
        for m in list(_METHODS) + list(_ARG_METHODS):
            handlers[m] = grpc.unary_unary_rpc_method_handler(
                self._handler(m),
                request_deserializer=_ident,
                response_serializer=_ident,
            )
        self._server.add_generic_rpc_handlers(
            (grpc.method_handlers_generic_handler(SERVICE, handlers),)
        )
        port = self._server.add_insecure_port(
            f"{self._host}:{self._port}"
        )
        self.addr = (self._host, port)
        self._server.start()

    def on_stop(self) -> None:
        if self._server is not None:
            self._server.stop(grace=1.0).wait()


class ABCIGRPCClient(abci.Application):
    """abci/client/grpc_client.go: an Application proxy over gRPC.

    Unlike ABCISocketClient there is NO connection mutex — gRPC
    multiplexes concurrent calls on one HTTP/2 channel, so the four
    logical AppConns issue requests in parallel (the reference grpc
    client's whole point)."""

    def __init__(self, host: str, port: int, timeout: float = 30.0):
        import grpc

        self._timeout = timeout
        self._channel = grpc.insecure_channel(f"{host}:{port}")
        self._stubs = {
            m: self._channel.unary_unary(
                f"/{SERVICE}/{m}",
                request_serializer=_ident,
                response_deserializer=_ident,
            )
            for m in list(_METHODS) + list(_ARG_METHODS)
        }

    def wait_ready(self, timeout: float = 10.0) -> None:
        import grpc

        grpc.channel_ready_future(self._channel).result(timeout=timeout)

    def close(self) -> None:
        self._channel.close()

    def _call(self, method: str, req=None):
        _, resp_cls = _METHODS[method]
        doc = {"m": method}
        if req is not None:
            doc["q"] = _enc(req)
        body = self._stubs[method](
            json.dumps(doc).encode(), timeout=self._timeout
        )
        return _rebuild(resp_cls, _dec(json.loads(body.decode())))

    def info(self, req):
        return self._call("info", req)

    def init_chain(self, req):
        return self._call("init_chain", req)

    def check_tx(self, req):
        return self._call("check_tx", req)

    def prepare_proposal(self, req):
        return self._call("prepare_proposal", req)

    def process_proposal(self, req):
        return self._call("process_proposal", req)

    def finalize_block(self, req):
        return self._call("finalize_block", req)

    def commit(self):
        return self._call("commit")

    def query(self, req):
        return self._call("query", req)

    def extend_vote(self, req):
        return self._call("extend_vote", req)

    def verify_vote_extension(self, req):
        return self._call("verify_vote_extension", req)

    def _call_args(self, method: str, *args):
        resp_fix = _ARG_METHODS[method][1]
        body = self._stubs[method](
            json.dumps({"m": method, "a": _enc(list(args))}).encode(),
            timeout=self._timeout,
        )
        r = _dec(json.loads(body.decode()))
        return resp_fix(r) if resp_fix else r

    def list_snapshots(self):
        return self._call_args("list_snapshots")

    def offer_snapshot(self, snapshot):
        return self._call_args("offer_snapshot", snapshot)

    def load_snapshot_chunk(self, height, fmt, chunk):
        return self._call_args("load_snapshot_chunk", height, fmt, chunk)

    def apply_snapshot_chunk(self, index, chunk, sender):
        return self._call_args("apply_snapshot_chunk", index, chunk,
                               sender)
