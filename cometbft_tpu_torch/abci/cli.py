"""abci-cli: serve the example app over a socket and poke ABCI
servers from the command line.

Reference: abci/cmd/abci-cli/abci-cli.go (serve/kvstore, console with
info/query/check_tx, one-shot commands). Wire format is the framed
JSON codec in abci/server.py.

The port's copy of the JAX package's abci/cli.py.
"""
from __future__ import annotations

import argparse
import shlex
import signal
import sys
import time

from cometbft_tpu_torch.abci import types as abci


def _tx_arg(s: str) -> bytes:
    if s.startswith("0x"):
        return bytes.fromhex(s[2:])
    return s.encode()


def _connect(addr: str):
    from cometbft_tpu_torch.abci.server import ABCISocketClient

    host, _, port = addr.rpartition(":")
    return ABCISocketClient(host or "127.0.0.1", int(port))


def cmd_serve(args) -> int:
    """abci-cli kvstore: run the example app as a socket or gRPC
    server (abci-cli.go --abci / grpc_server.go)."""
    from cometbft_tpu_torch.abci.kvstore import KVStoreApplication

    if getattr(args, "transport", "socket") == "grpc":
        from cometbft_tpu_torch.abci.grpc import ABCIGRPCServer as Server
    else:
        from cometbft_tpu_torch.abci.server import ABCISocketServer as Server

    srv = Server(KVStoreApplication(), host=args.host, port=args.port)
    srv.start()
    print(f"abci kvstore serving on {srv.addr[0]}:{srv.addr[1]} "
          f"({getattr(args, 'transport', 'socket')})", flush=True)
    stop = []
    signal.signal(signal.SIGINT, lambda *a: stop.append(1))
    signal.signal(signal.SIGTERM, lambda *a: stop.append(1))
    t0 = time.time()
    while not stop and (args.run_for <= 0
                        or time.time() < t0 + args.run_for):
        time.sleep(0.2)
    srv.stop()
    return 0


def _run_one(client, cmd: str, argv: list) -> None:
    if cmd in ("check_tx", "query") and not argv:
        print(f"usage: {cmd} <{'tx' if cmd == 'check_tx' else 'key'}> "
              f"(string or 0x-hex)")
        return
    if cmd == "info":
        r = client.info(abci.RequestInfo())
        print(f"-> data: {r.data!r} height: {r.last_block_height} "
              f"app_hash: {r.last_block_app_hash.hex()}")
    elif cmd == "check_tx":
        r = client.check_tx(abci.RequestCheckTx(tx=_tx_arg(argv[0])))
        print(f"-> code: {r.code} log: {r.log!r}")
    elif cmd == "query":
        r = client.query(abci.RequestQuery(data=_tx_arg(argv[0])))
        print(f"-> code: {r.code} key: {r.key!r} value: {r.value!r}")
    elif cmd == "commit":
        client.commit()
        print("-> ok")
    elif cmd == "echo":
        # no Echo RPC in the method table: info round-trips instead
        client.info(abci.RequestInfo())
        print(f"-> {argv[0] if argv else ''}")
    else:
        print(f"unknown command {cmd!r} "
              f"(info|check_tx|query|commit|echo)")


def cmd_console(args) -> int:
    """abci-cli console: interactive REPL against a running server."""
    client = _connect(args.addr)
    print(f"connected to {args.addr}; commands: "
          f"info, check_tx <tx>, query <key>, commit, echo, quit")
    for line in sys.stdin:
        parts = shlex.split(line.strip())
        if not parts:
            continue
        if parts[0] in ("quit", "exit"):
            break
        try:
            _run_one(client, parts[0], parts[1:])
        except Exception as e:  # noqa: BLE001 - REPL survives bad input
            print(f"error: {e}")
    client.close()
    return 0


def cmd_oneshot(args) -> int:
    client = _connect(args.addr)
    try:
        _run_one(client, args.abci_cmd, args.args)
    finally:
        client.close()
    return 0


def add_abci_subcommands(sub) -> None:
    """Mount the abci-cli under the main CLI (`cometbft_tpu_torch abci ...`)."""
    p = sub.add_parser("abci", help="ABCI tools (serve/console/one-shot)")
    asub = p.add_subparsers(dest="abci_sub", required=True)

    q = asub.add_parser("kvstore", help="serve the kvstore app")
    q.add_argument("--host", default="127.0.0.1")
    q.add_argument("--port", type=int, default=26658)
    q.add_argument("--run-for", type=float, default=0)
    q.add_argument("--transport", choices=("socket", "grpc"),
                   default="socket",
                   help="ABCI server transport (abci-cli.go --abci)")
    q.set_defaults(fn=cmd_serve)

    q = asub.add_parser("console", help="interactive ABCI console")
    q.add_argument("--addr", default="127.0.0.1:26658")
    q.set_defaults(fn=cmd_console)

    for name in ("info", "check_tx", "query", "commit", "echo"):
        q = asub.add_parser(name)
        q.add_argument("args", nargs="*")
        q.add_argument("--addr", default="127.0.0.1:26658")
        q.set_defaults(fn=cmd_oneshot, abci_cmd=name)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="abci-cli")
    sub = parser.add_subparsers(dest="command", required=True)
    add_abci_subcommands(sub)
    args = parser.parse_args(["abci"] + (argv or sys.argv[1:]))
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
