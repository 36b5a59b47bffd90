"""abci-cli: exercise an ABCI application from the command line (the
port's copy of tendermint_tpu/abci_cli.py; it prints the same lines).

Reference parity: abci/cmd/abci-cli/abci-cli.go — serve the example apps
(`kvstore`, `counter`) over the socket or, with `--abci grpc`, the gRPC
transport (abci/grpc.py), drive a running server with one-shot commands
(echo/info/deliver_tx/check_tx/commit/query), and run command scripts via
`console` (interactive) / `batch` (stdin).  `info`
prints the app's data, last block height and app hash (the JAX CLI raises
AttributeError on the string `data` of ResponseInfo: ROADMAP 3.8).

Usage (the global flags come before the command):
    python -m tendermint_tpu_torch.abci_cli --address tcp://0.0.0.0:26658 kvstore
    python -m tendermint_tpu_torch.abci_cli --abci grpc --address tcp://127.0.0.1:26658 kvstore
    python -m tendermint_tpu_torch.abci_cli --address ... deliver_tx 0x74783d31
    echo -e "deliver_tx 0x01\\ncommit" | python -m tendermint_tpu_torch.abci_cli batch
"""

from __future__ import annotations

import argparse
import asyncio
import shlex
import sys

from .abci import types as t
from .abci.client import SocketClient
from .abci.examples import CounterApplication, KVStoreApplication

DEFAULT_ADDR = "tcp://0.0.0.0:26658"


def _parse_bytes(arg: str) -> bytes:
    """abci-cli.go:stringOrHexToBytes — 0x-hex or quoted/plain string."""
    if arg.startswith("0x"):
        return bytes.fromhex(arg[2:])
    if len(arg) >= 2 and arg[0] == '"' and arg[-1] == '"':
        return arg[1:-1].encode()
    return arg.encode()


def _print_response(res) -> None:
    code = getattr(res, "code", 0)
    print(f"-> code: {'OK' if code == 0 else code}")
    data = getattr(res, "data", b"")
    if isinstance(data, str):  # ResponseInfo.data (the JAX CLI raises here)
        data = data.encode()
    if data:
        try:
            print(f"-> data: {data.decode()}")
        except UnicodeDecodeError:
            pass
        print(f"-> data.hex: 0x{data.hex().upper()}")
    log = getattr(res, "log", "")
    if log:
        print(f"-> log: {log}")
    for extra in ("key", "value", "height", "info", "message"):
        v = getattr(res, extra, None)
        if v:
            if isinstance(v, bytes):
                print(f"-> {extra}: {v.decode(errors='replace')}")
            else:
                print(f"-> {extra}: {v}")
    if isinstance(res, t.ResponseInfo):
        print(f"-> last_block_height: {res.last_block_height}")
        print(f"-> last_block_app_hash: 0x{res.last_block_app_hash.hex().upper()}")


_ARITY = {"deliver_tx": 1, "check_tx": 1, "query": 1, "set_option": 2}


async def _run_command(client, cmd: str, args: list) -> bool:
    """Execute one console/batch command; False for unknown/short commands."""
    if len(args) < _ARITY.get(cmd, 0):
        print(
            f"{cmd}: want {_ARITY[cmd]} argument(s), got {len(args)}", file=sys.stderr
        )
        return False
    if cmd == "echo":
        _print_response(await client.echo(args[0] if args else ""))
    elif cmd == "info":
        _print_response(await client.info(t.RequestInfo(version="abci-cli")))
    elif cmd == "deliver_tx":
        _print_response(await client.deliver_tx(t.RequestDeliverTx(tx=_parse_bytes(args[0]))))
    elif cmd == "check_tx":
        _print_response(await client.check_tx(t.RequestCheckTx(tx=_parse_bytes(args[0]))))
    elif cmd == "commit":
        _print_response(await client.commit())
    elif cmd == "query":
        _print_response(
            await client.query(t.RequestQuery(data=_parse_bytes(args[0]), path="/key"))
        )
    elif cmd == "set_option":
        _print_response(
            await client.set_option(t.RequestSetOption(key=args[0], value=args[1]))
        )
    else:
        print(f"unknown command {cmd!r}", file=sys.stderr)
        return False
    return True


def _make_client(args):
    if args.abci == "grpc":
        from .abci.grpc import GRPCClient

        return GRPCClient(args.address)
    return SocketClient(args.address)


async def _with_client(args, fn) -> int:
    client = _make_client(args)
    await client.start()
    try:
        return await fn(client)
    finally:
        await client.stop()


def cmd_serve(args, app) -> int:
    async def main():
        if args.abci == "grpc":
            from .abci.grpc import GRPCServer

            server = GRPCServer(args.address, app)
        else:
            from .abci.server import SocketServer

            server = SocketServer(args.address, app)
        await server.start()
        print(f"ABCI {type(app).__name__} serving on {args.address} ({args.abci})")
        try:
            await asyncio.Event().wait()
        except (KeyboardInterrupt, asyncio.CancelledError):
            pass
        await server.stop()
        return 0

    try:
        return asyncio.run(main())
    except KeyboardInterrupt:
        return 0


def cmd_oneshot(args) -> int:
    async def run(client):
        ok = await _run_command(client, args.cmd, args.args)
        return 0 if ok else 1

    return asyncio.run(_with_client(args, run))


def cmd_batch(args) -> int:
    async def run(client):
        rc = 0
        for line in sys.stdin:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            print(f"> {line}")
            parts = shlex.split(line, posix=False)
            try:
                if not await _run_command(client, parts[0], parts[1:]):
                    rc = 1
            except Exception as e:  # a bad line must not abort the batch
                print(f"error: {e}", file=sys.stderr)
                rc = 1
        return rc

    return asyncio.run(_with_client(args, run))


def cmd_console(args) -> int:
    async def run(client):
        print('ABCI console. Commands: echo info deliver_tx check_tx commit query ("quit" exits)')
        while True:
            try:
                line = input("> ").strip()
            except EOFError:
                return 0
            if line in ("quit", "exit"):
                return 0
            if not line:
                continue
            parts = shlex.split(line, posix=False)
            try:
                await _run_command(client, parts[0], parts[1:])
            except Exception as e:
                print(f"error: {e}", file=sys.stderr)

    return asyncio.run(_with_client(args, run))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="abci-cli", description="ABCI command-line interface")
    p.add_argument("--address", default=DEFAULT_ADDR, help="ABCI server address")
    p.add_argument("--abci", default="socket", choices=("socket", "grpc"), help="transport")
    sub = p.add_subparsers(dest="command", required=True)
    for name in ("kvstore", "counter"):
        sub.add_parser(name, help=f"serve the example {name} app")
    sub.add_parser("console", help="interactive console against a running server")
    sub.add_parser("batch", help="run commands from stdin")
    for name in ("echo", "info", "deliver_tx", "check_tx", "commit", "query", "set_option"):
        sp = sub.add_parser(name)
        sp.add_argument("args", nargs="*")
    args = p.parse_args(argv)
    if args.command == "kvstore":
        return cmd_serve(args, KVStoreApplication())
    if args.command == "counter":
        return cmd_serve(args, CounterApplication())
    if args.command == "console":
        return cmd_console(args)
    if args.command == "batch":
        return cmd_batch(args)
    args.cmd = args.command
    return cmd_oneshot(args)


if __name__ == "__main__":
    sys.exit(main())
