"""Command-line interface (the port's copy of tendermint_tpu/cli.py, with the
commands of a node and its keys).

Reference parity: cmd/tendermint/main.go:16-45 (init, node/run, testnet,
replay, replay_console, gen_validator, gen_node_key, show_validator,
show_node_id, unsafe_reset_all, lite, version), commands/testnet.go (the
N-validator config-tree generator) and the light-client gateway
(`liteserve`).
Each command takes the JAX CLI's arguments, prints its lines and returns
its exit codes.  `node` serves RPC at the home's `rpc.laddr` (and
state-syncs with `[statesync] enable`), as the JAX node does.  `testnet`'s
`--chaos` rig waits for the chaos layers (ROADMAP 1.8), `debug` for the
flight spool it bundles, as do `trace` and `trace_net` (ROADMAP 1.8).

argparse plays cobra's role; `python -m tendermint_tpu_torch <cmd>` is the
binary.  `node`, `light` and `liteserve` run their verify engine on the
card: `node` raises without one, `light` and `liteserve` exit 1.
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


def _testnet_peer_indices(i: int, n: int):
    """Persistent-peer topology for an n-node testnet.  Small nets keep
    the reference's full mesh; past 16 nodes a chordal ring (offsets
    1, 2, 4, ... mod n) bounds per-node connections at O(log n) while
    keeping diameter O(log n)."""
    if n <= 16:
        return [j for j in range(n) if j != i]
    offsets, k = [], 1
    while k < n:
        offsets.append(k)
        k *= 2
    return sorted({(i + off) % n for off in offsets} - {i})


def _load_or_draw_pv(cfg: Config, draw_key):
    from .privval.file import FilePV, FilePVKey, FilePVLastSignState, load_or_gen_file_pv

    if draw_key is None or os.path.exists(cfg.priv_validator_key_file()):
        return load_or_gen_file_pv(cfg)
    priv = draw_key()
    pv = FilePV(FilePVKey(priv.pub_key().address(), priv.pub_key(), priv,
                          cfg.priv_validator_key_file()),
                FilePVLastSignState(file_path=cfg.priv_validator_state_file()))
    pv.save()
    return pv


def _load_or_draw_node_key(cfg: Config, draw_key):
    from .p2p.key import NodeKey

    path = cfg.node_key_file()
    if draw_key is None or os.path.exists(path):
        return NodeKey.load_or_gen(path)
    nk = NodeKey(draw_key())
    nk.save_as(path)
    return nk


def cmd_testnet(args, draw_key=None) -> int:
    """commands/testnet.go — an N-validator config tree under --output;
    every node lists every other as a persistent peer (the docker-compose
    localnet topology on localhost ports).

    `--fast` writes throughput-rig configs: test-grade consensus timeouts
    with skip_timeout_commit (the config.go:792 TestConfig shape) and a
    genesis with time_iota_ms=1 so block time cannot outrun wall clock
    when commits are sub-second.  `--chaos`, `--twin` and `--chaos-seed`
    need the chaos layers (ROADMAP 1.8) and exit 2.

    `draw_key` makes each new key, a validator's then its node key, node
    by node (default: a fresh random key, as the JAX command draws)."""
    n = args.validators
    out = os.path.abspath(args.output)
    chain_id = args.chain_id or f"testnet-{os.urandom(3).hex()}"
    fast = getattr(args, "fast", False)
    if getattr(args, "chaos", False) or getattr(args, "twin", -1) >= 0 or getattr(
            args, "chaos_seed", 0):
        print("--chaos, --twin and --chaos-seed need the chaos layers, which are not ported "
              "yet (ROADMAP 1.8)", file=sys.stderr)
        return 2
    key_type = getattr(args, "key_type", "ed25519") or "ed25519"
    homes, pvs, node_keys = [], [], []
    for i in range(n):
        home = os.path.join(out, f"node{i}")
        cfg = Config(home=home)
        cfg.base.chain_id = chain_id
        cfg.base.key_type = key_type
        cfg.ensure_dirs()
        pvs.append(_load_or_draw_pv(cfg, draw_key))
        node_keys.append(_load_or_draw_node_key(cfg, draw_key))
        homes.append(home)

    consensus_params = None
    if fast:
        from .types.params import BlockParams, ConsensusParams

        consensus_params = ConsensusParams(block=BlockParams(time_iota_ms=1))
    genesis = GenesisDoc(
        chain_id=chain_id,
        genesis_time_ns=time.time_ns(),
        validators=[GenesisValidator(pv.address(), pv.get_pub_key(), 10) for pv in pvs],
        consensus_params=consensus_params,
    )
    base_port = args.base_port
    docker = getattr(args, "populate_docker_addresses", False)
    for i, home in enumerate(homes):
        cfg = Config(home=home)
        cfg.base.chain_id = chain_id
        cfg.base.key_type = key_type
        cfg.base.moniker = f"node{i}"
        if docker:
            # networks/local topology: fixed container IPs, standard ports
            cfg.p2p.laddr = "tcp://0.0.0.0:26656"
            cfg.rpc.laddr = "tcp://0.0.0.0:26657"
            cfg.p2p.persistent_peers = ",".join(
                f"{node_keys[j].id}@192.167.10.{2 + j}:26656" for j in range(n) if j != i
            )
        else:
            cfg.p2p.laddr = f"tcp://127.0.0.1:{base_port + 10 * i}"
            cfg.rpc.laddr = f"tcp://127.0.0.1:{base_port + 10 * i + 1}"
            cfg.p2p.persistent_peers = ",".join(
                f"{node_keys[j].id}@127.0.0.1:{base_port + 10 * j}"
                for j in _testnet_peer_indices(i, n)
            )
        cfg.p2p.allow_duplicate_ip = True
        # peer-set sizing: a big testnet must not trip the reference's
        # 40-inbound default
        cfg.p2p.max_num_inbound_peers = max(cfg.p2p.max_num_inbound_peers, n + 8)
        cfg.p2p.max_num_outbound_peers = max(
            cfg.p2p.max_num_outbound_peers, len(_testnet_peer_indices(i, n))
        )
        if fast:
            cfg.base.fast_sync = False
            cfg.base.db_backend = args.db_backend or "memdb"
            # small-net rig: every vote batch is below min_device_batch, so
            # verification stays on the host path, as in the JAX rig
            cfg.tpu.enabled = False
            cfg.consensus.timeout_propose = 0.1
            cfg.consensus.timeout_propose_delta = 0.002
            cfg.consensus.timeout_prevote = 0.02
            cfg.consensus.timeout_prevote_delta = 0.002
            cfg.consensus.timeout_precommit = 0.02
            cfg.consensus.timeout_precommit_delta = 0.002
            cfg.consensus.timeout_commit = 0.0
            cfg.consensus.skip_timeout_commit = True
            cfg.consensus.peer_gossip_sleep_duration = 0.005
            cfg.consensus.peer_query_maj23_sleep_duration = 0.25
            cfg.instrumentation.loop_probe_interval = 0.02
            cfg.instrumentation.watchdog_interval = 0.25
            cfg.instrumentation.watchdog_stall_seconds = 3.0
        elif args.db_backend:
            cfg.base.db_backend = args.db_backend
        _write_cfg(cfg)
        genesis.save_as(cfg.genesis_file())
    print(f"Successfully initialized {n} node directories in {out} (chain_id={chain_id})")
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


def _engine_device(command: str):
    """The card for a command's verify engine, or None after telling the
    operator that there is none."""
    from .crypto.batch_verifier import resolve_device

    try:
        return resolve_device(None)
    except RuntimeError as e:
        print(f"{command}: {e}", file=sys.stderr)
        return None


def engine_account(recorder) -> dict:
    """What a command's verify engine did, for its exit log line: the
    kernels' launches in this process, its dispatches by path and its table
    lookups (of the events still in `recorder`'s ring), as compact JSON."""
    from collections import Counter

    from .ops import ed25519_cuda, ed25519_table

    launches = {"ed25519_ladder": ed25519_cuda.LAUNCHES,
                "ed25519_window_tables": ed25519_table.BUILD_LAUNCHES,
                "ed25519_tabulated": ed25519_table.SUM_LAUNCHES}
    paths = Counter(e["path"] for e in recorder.events(kinds=["verify.dispatch"]))
    tables = Counter("hit" if e["hit"] else "miss"
                     for e in recorder.events(kinds=["verify.table"]))
    return {k: json.dumps(v, sort_keys=True, separators=(",", ":"))
            for k, v in (("launches", launches), ("paths", dict(paths)),
                         ("tables", dict(tables)))}


def cmd_light(args) -> int:
    """commands/lite.go — run a light-client proxy against a primary
    (lite2/proxy.py).  Its client verifies through the crypto.batch hooks
    of the card's engine (node.install_engine: no AsyncBatchVerifier, so no
    warmup mode and no host path while the kernel library builds); without
    a card the command exits 1 before anything starts.  At exit it logs the
    engine's account (engine_account)."""
    from .config import Config
    from .libs.log import get_logger, setup as setup_logging
    from .libs.tracing import FlightRecorder
    from .lite2.proxy import run_proxy
    from .node import install_engine, uninstall_engine

    device = _engine_device("light")
    if device is None:
        return 1
    setup_logging()

    async def _main() -> None:
        log = get_logger("light")
        log.info("verify engine", device=device)
        recorder = FlightRecorder()
        bv, table_cache = install_engine(Config().tpu, device, recorder=recorder)
        proxy = asyncio.ensure_future(
            run_proxy(
                chain_id=args.chain_id,
                primary_addr=args.primary,
                witness_addrs=[w for w in (args.witnesses or "").split(",") if w],
                laddr=args.laddr,
                trust_height=args.height,
                trust_hash=bytes.fromhex(args.hash),
                trusting_period_s=args.trusting_period,
            )
        )
        loop = asyncio.get_event_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            try:
                loop.add_signal_handler(sig, proxy.cancel)
            except NotImplementedError:  # pragma: no cover — non-unix
                pass
        try:
            await proxy
        except asyncio.CancelledError:
            pass
        finally:
            uninstall_engine(bv, table_cache)
            log.info("verify engine account", **engine_account(recorder))

    asyncio.run(_main())
    return 0


def cmd_liteserve(args) -> int:
    """Run the standalone multi-tenant light-client verification gateway
    (liteserve/service.py): lite_* JSON-RPC routes off one shared
    verification engine with witness rotation and a bounded session table.

    The engine is the card's, built as the node builds it (node.build_engine:
    the flat and indexed crypto.batch hooks and the AsyncBatchVerifier
    the gateway's cache verifies through); without a card the command
    exits 1 before anything starts."""
    from .config import Config
    from .liteserve.service import run_service
    from .node import build_engine, uninstall_engine

    device = _engine_device("liteserve")
    if device is None:
        return 1
    kwargs = {}
    if args.metrics_laddr:
        from .libs.metrics import MetricsProvider

        provider = MetricsProvider(True, args.chain_id)
        kwargs["metrics"] = provider.liteserve
        kwargs["metrics_provider"] = provider

    async def _main() -> None:
        bv, table_cache, abv = build_engine(Config().tpu, device)
        await abv.start()
        service = asyncio.ensure_future(
            run_service(
                chain_id=args.chain_id,
                primary_addr=args.primary,
                witness_addrs=[w for w in (args.witnesses or "").split(",") if w],
                laddr=args.laddr,
                trust_height=args.height,
                trust_hash=bytes.fromhex(args.hash),
                trusting_period_s=args.trusting_period,
                cache_capacity=args.cache_capacity,
                max_sessions=args.max_sessions,
                session_rate=args.session_rate,
                session_burst=args.session_burst,
                create_rate=args.create_rate,
                create_burst=args.create_burst,
                witness_quorum=args.witness_quorum,
                witness_timeout_s=args.witness_timeout,
                rotation_seed=args.rotation_seed,
                async_verifier=abv,
                **kwargs,
            )
        )
        loop = asyncio.get_event_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            try:
                loop.add_signal_handler(sig, service.cancel)
            except NotImplementedError:  # pragma: no cover — non-unix
                pass
        try:
            await service
        except asyncio.CancelledError:
            pass
        finally:
            await abv.stop()
            uninstall_engine(bv, table_cache)

    asyncio.run(_main())
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

    sp = sub.add_parser("testnet", help="generate an N-validator testnet config tree")
    sp.add_argument("--validators", "-v", type=int, default=4)
    sp.add_argument("--output", "-o", default="./mytestnet")
    sp.add_argument("--chain-id", default="")
    sp.add_argument("--base-port", type=int, default=26656)
    sp.add_argument(
        "--populate-docker-addresses",
        action="store_true",
        help="wire peers for the docker-compose localnet (192.167.10.x)",
    )
    sp.add_argument(
        "--fast",
        action="store_true",
        help="throughput-rig configs: test-grade timeouts, skip_timeout_commit, "
        "time_iota_ms=1 genesis, memdb",
    )
    sp.add_argument("--db-backend", choices=["sqlite", "memdb"], default="")
    sp.add_argument("--chaos", action="store_true",
                    help="chaos rig (needs the chaos layers: not ported yet, ROADMAP 1.8)")
    sp.add_argument("--chaos-seed", type=int, default=0,
                    help="seed for every probabilistic fault decision (ROADMAP 1.8)")
    sp.add_argument("--twin", type=int, default=-1,
                    help="node index to run as a double-signing twin (ROADMAP 1.8)")
    sp.add_argument(
        "--key-type", choices=list(KEY_TYPES), default="ed25519",
        help="consensus key scheme for every generated validator key (only ed25519 is ported)",
    )
    sp.set_defaults(fn=cmd_testnet)

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

    sp = sub.add_parser("light", help="run a verifying light-client RPC proxy")
    sp.add_argument("--chain-id", required=True)
    sp.add_argument("--primary", required=True, help="primary node RPC address")
    sp.add_argument("--witnesses", default="", help="comma-separated witness RPC addresses")
    sp.add_argument("--laddr", default="tcp://127.0.0.1:8888")
    sp.add_argument("--height", type=int, required=True, help="trusted height")
    sp.add_argument("--hash", required=True, help="trusted header hash (hex)")
    sp.add_argument("--trusting-period", type=float, default=168 * 3600)
    sp.set_defaults(fn=cmd_light)

    sp = sub.add_parser(
        "liteserve",
        help="run the multi-tenant light-client verification gateway",
    )
    sp.add_argument("--chain-id", required=True)
    sp.add_argument("--primary", required=True, help="primary node RPC address")
    sp.add_argument("--witnesses", default="", help="comma-separated witness RPC addresses")
    sp.add_argument("--laddr", default="tcp://127.0.0.1:8899")
    sp.add_argument("--height", type=int, required=True, help="trusted height")
    sp.add_argument("--hash", required=True, help="trusted header hash (hex)")
    sp.add_argument("--trusting-period", type=float, default=168 * 3600)
    sp.add_argument("--cache-capacity", type=int, default=4096)
    sp.add_argument("--max-sessions", type=int, default=4096)
    sp.add_argument("--session-rate", type=float, default=0.0,
                    help="per-session requests/sec (0 = unlimited)")
    sp.add_argument("--session-burst", type=int, default=50)
    sp.add_argument("--create-rate", type=float, default=0.0,
                    help="per-source session creates/sec (0 = unlimited)")
    sp.add_argument("--create-burst", type=int, default=20)
    sp.add_argument("--witness-quorum", type=int, default=2)
    sp.add_argument("--witness-timeout", type=float, default=3.0)
    sp.add_argument("--rotation-seed", type=int, default=0)
    sp.add_argument("--metrics-laddr", default="",
                    help="serve /metrics on the gateway listener (any value enables)")
    sp.set_defaults(fn=cmd_liteserve)

    sp = sub.add_parser("version", help="print version")
    sp.set_defaults(fn=cmd_version)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
