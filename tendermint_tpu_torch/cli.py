"""Command-line interface (the port's copy of tendermint_tpu/cli.py, with the
commands a node without p2p can serve).

Reference parity: cmd/tendermint/main.go:16-45 (init, node/run, replay,
replay_console, gen_validator, gen_node_key, show_validator, show_node_id,
unsafe_reset_all, version).  Each command takes the JAX CLI's arguments,
prints its lines and returns its exit codes.  `testnet`, `light`,
`liteserve` and `debug` come with p2p and RPC (ROADMAP 1.7), `trace` and
`trace_net` with the flight spool (ROADMAP 1.8).

argparse plays cobra's role; `python -m tendermint_tpu_torch <cmd>` is the
binary.  `node` runs its verify engine on the card and raises without one.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import shutil
import signal
import sys
import time

from .config import Config, load_config, save_config
from .crypto.keys import KEY_TYPES
from .types.genesis import GenesisDoc, GenesisValidator


def _load_cfg(home: str) -> Config:
    path = os.path.join(os.path.expanduser(home), "config", "config.toml")
    if os.path.exists(path):
        return load_config(path, home=home)
    return Config(home=home)


def _write_cfg(cfg: Config) -> None:
    cfg.ensure_dirs()
    save_config(cfg, os.path.join(os.path.expanduser(cfg.home), "config", "config.toml"))


# -- commands ---------------------------------------------------------------


def cmd_init(args) -> int:
    """commands/init.go — config.toml, genesis with this node as the sole
    validator, priv_validator key/state, node key."""
    from .p2p.key import NodeKey
    from .privval.file import load_or_gen_file_pv

    cfg = Config(home=args.home)
    cfg.base.chain_id = args.chain_id or f"test-chain-{os.urandom(3).hex()}"
    cfg.base.key_type = getattr(args, "key_type", "ed25519") or "ed25519"
    _write_cfg(cfg)
    pv = load_or_gen_file_pv(cfg)
    NodeKey.load_or_gen(cfg.node_key_file())
    gen_file = cfg.genesis_file()
    if not os.path.exists(gen_file):
        gen = GenesisDoc(
            chain_id=cfg.base.chain_id,
            genesis_time_ns=time.time_ns(),
            validators=[GenesisValidator(pv.address(), pv.get_pub_key(), 10)],
        )
        gen.save_as(gen_file)
    print(f"Initialized node in {cfg.home} (chain_id={cfg.base.chain_id})")
    return 0


def cmd_run(args) -> int:
    """commands/run_node.go:97 — run a node until SIGINT/SIGTERM."""
    import gc

    from .node import default_new_node

    # Long-running node: the default gen0 threshold (700 allocations) fires
    # collections mid-consensus-step thousands of times per second under
    # message churn.  Collect far less often — the working set is mostly
    # acyclic (bytes/dataclasses), so gen0 pressure is cheap to defer.
    gc.set_threshold(50_000, 50, 25)

    from .libs.log import parse_log_level, setup as setup_logging

    cfg = _load_cfg(args.home)
    if args.proxy_app:
        cfg.base.proxy_app = args.proxy_app
    cfg.validate_basic()
    # honor [base] log_level — without a handler the node's structured
    # logs vanish entirely
    setup_logging(module_levels=parse_log_level(cfg.base.log_level))
    node = default_new_node(cfg)

    async def _main() -> None:
        loop = asyncio.get_event_loop()
        stop = asyncio.Event()
        for sig in (signal.SIGINT, signal.SIGTERM):
            try:
                loop.add_signal_handler(sig, stop.set)
            except NotImplementedError:  # pragma: no cover — non-unix
                pass
        await node.start()
        print(f"node started: chain={node.genesis_doc.chain_id}", flush=True)
        await stop.wait()
        await node.stop()

    asyncio.run(_main())
    return 0


def cmd_gen_validator(args) -> int:
    """commands/gen_validator.go — print a fresh FilePV key as JSON."""
    from .crypto.keys import Ed25519PrivKey

    priv = Ed25519PrivKey.generate()
    print(
        json.dumps(
            {
                "address": priv.pub_key().address().hex().upper(),
                "pub_key": {"type": priv.pub_key().TYPE, "value": priv.pub_key().bytes().hex()},
                "priv_key": {"type": priv.TYPE, "value": priv.bytes().hex()},
            },
            indent=2,
        )
    )
    return 0


def cmd_gen_node_key(args) -> int:
    from .p2p.key import NodeKey

    cfg = Config(home=args.home)
    cfg.ensure_dirs()
    nk = NodeKey.load_or_gen(cfg.node_key_file())
    print(nk.id)
    return 0


def cmd_show_node_id(args) -> int:
    from .p2p.key import NodeKey

    cfg = _load_cfg(args.home)
    path = cfg.node_key_file()
    if not os.path.exists(path):
        print("node key not found; run `init` first", file=sys.stderr)
        return 1
    print(NodeKey.load(path).id)
    return 0


def cmd_show_validator(args) -> int:
    from .privval.file import FilePV

    cfg = _load_cfg(args.home)
    if not os.path.exists(cfg.priv_validator_key_file()):
        print("priv_validator key not found; run `init` first", file=sys.stderr)
        return 1
    pv = FilePV.load(cfg.priv_validator_key_file(), cfg.priv_validator_state_file())
    pub = pv.get_pub_key()
    print(json.dumps({"type": pub.TYPE, "value": pub.bytes().hex()}))
    return 0


def cmd_unsafe_reset_all(args) -> int:
    """commands/reset_priv_validator.go — wipe data, keep keys."""
    cfg = _load_cfg(args.home)
    data = cfg.db_dir()
    if os.path.isdir(data):
        shutil.rmtree(data)
    os.makedirs(data, exist_ok=True)
    # reset the last-sign state (fresh chain ⇒ heights restart)
    state_file = cfg.priv_validator_state_file()
    if os.path.exists(state_file):
        os.unlink(state_file)
    print(f"Reset {data}")
    return 0


def cmd_replay(args) -> int:
    """commands/replay.go — replay the WAL through a fresh consensus state
    (console mode steps interactively)."""
    from .consensus.replay_file import run_replay_file

    cfg = _load_cfg(args.home)
    asyncio.run(run_replay_file(cfg, console=args.console))
    return 0


def cmd_version(args) -> int:
    from . import version

    print(version.VERSION)
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tendermint_tpu_torch",
        description="BFT state-machine replication engine, verifying on a CUDA card",
    )
    p.add_argument("--home", default=os.environ.get("TMHOME", "~/.tendermint_tpu"))
    sub = p.add_subparsers(dest="command", required=True)

    sp = sub.add_parser("init", help="initialize a home directory")
    sp.add_argument("--chain-id", default="")
    sp.add_argument(
        "--key-type", choices=list(KEY_TYPES), default="ed25519",
        help="consensus key scheme for the generated priv_validator key "
        "(only ed25519 is ported)",
    )
    sp.set_defaults(fn=cmd_init)

    sp = sub.add_parser("node", aliases=["run", "start"], help="run a node")
    sp.add_argument("--proxy-app", default="")
    sp.set_defaults(fn=cmd_run)

    sp = sub.add_parser("gen_validator", help="generate a validator keypair")
    sp.set_defaults(fn=cmd_gen_validator)

    sp = sub.add_parser("gen_node_key", help="generate (or show) the node key")
    sp.set_defaults(fn=cmd_gen_node_key)

    sp = sub.add_parser("show_node_id", help="show this node's p2p ID")
    sp.set_defaults(fn=cmd_show_node_id)

    sp = sub.add_parser("show_validator", help="show this node's validator pubkey")
    sp.set_defaults(fn=cmd_show_validator)

    sp = sub.add_parser("unsafe_reset_all", help="wipe blockchain data (keeps keys)")
    sp.set_defaults(fn=cmd_unsafe_reset_all)

    sp = sub.add_parser("replay", help="replay the consensus WAL")
    sp.add_argument("--console", action="store_true", help="step interactively")
    sp.set_defaults(fn=cmd_replay)

    sp = sub.add_parser("version", help="print version")
    sp.set_defaults(fn=cmd_version)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
