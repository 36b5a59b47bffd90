"""Command-line interface (the port's copy of tendermint_tpu/cli.py, with the
commands of a node and its keys).

Reference parity: cmd/tendermint/main.go:16-45 (init, node/run, testnet,
replay, replay_console, gen_validator, gen_node_key, show_validator,
show_node_id, unsafe_reset_all, lite, version), commands/testnet.go (the
N-validator config-tree generator) and the light-client gateway
(`liteserve`).
Each command takes the JAX CLI's arguments, prints its lines and returns
its exit codes.  `node` serves RPC at the home's `rpc.laddr` (and
state-syncs with `[statesync] enable`), as the JAX node does.  `testnet
--chaos` writes the chaos rig's homes (the fault layers and the unsafe
chaos routes on, `--twin` a double-signer).  The forensics
commands read a node's RPC or its home directory: `trace` (a node's flight
recorder, its span check and its stage and network budgets), `trace-net`
(dumps, spools or live nodes merged into one timeline, libs/tracemerge.py)
and `debug dump` / `kill` / `watch` (bundles, and the live telescope of
tools/telescope.py).

argparse plays cobra's role; `python -m tendermint_tpu_torch <cmd>` is the
binary.  `node`, `light` and `liteserve` run their verify engine on the
card: `node` raises without one, `light` and `liteserve` exit 1.  The
forensics commands do no device work and never import torch.
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
            validators=[
                GenesisValidator(pv.address(), pv.get_pub_key(), 10, pop=_pv_pop(pv))
            ],
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


def _pv_pop(pv) -> bytes:
    """Proof of possession for a FilePV's consensus key — non-empty only
    for BLS12-381 keys (genesis PoP enforcement requires it; other
    schemes don't carry one)."""
    priv = getattr(getattr(pv, "key", None), "priv_key", None)
    if priv is not None and hasattr(priv, "pop"):
        return priv.pop()
    return b""


def _load_or_draw_pv(cfg: Config, draw_key):
    from .privval.file import FilePV, FilePVKey, FilePVLastSignState, load_or_gen_file_pv

    if (draw_key is None or cfg.base.key_type != "ed25519"
            or os.path.exists(cfg.priv_validator_key_file())):
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
    when commits are sub-second.  `--chaos` turns on the fault layers and
    the unsafe chaos routes on every node, seeded by `--chaos-seed`; node
    `--twin` double-signs from genesis.

    `draw_key` makes each new ed25519 key, a validator's then its node
    key, node by node (default: a fresh random key, as the JAX command
    draws); a validator key of another `--key-type` comes from
    generate_priv_key."""
    n = args.validators
    out = os.path.abspath(args.output)
    chain_id = args.chain_id or f"testnet-{os.urandom(3).hex()}"
    fast = getattr(args, "fast", False)
    chaos = getattr(args, "chaos", False)
    twin = getattr(args, "twin", -1)
    if not chaos and (twin >= 0 or getattr(args, "chaos_seed", 0)):
        # fail NOW, not minutes later with "twin evidence never committed"
        print("--twin / --chaos-seed require --chaos", file=sys.stderr)
        return 2
    if twin >= n:
        print(f"--twin {twin} out of range for {n} validators", file=sys.stderr)
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
        validators=[
            GenesisValidator(pv.address(), pv.get_pub_key(), 10, pop=_pv_pop(pv))
            for pv in pvs
        ],
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
            if key_type == "bls12381":
                # BLS timing model: a reference-tier verify is a pairing,
                # so a proposal can cost more wall time to CHECK than the
                # ed25519-grade propose timeout — receivers would prevote
                # nil before the proposal lands and the net churns rounds.
                # Timeouts sit above pairing latency, as in the reference
                # package.
                cfg.consensus.timeout_propose = 2.0
                cfg.consensus.timeout_prevote = 0.5
                cfg.consensus.timeout_precommit = 0.5
            cfg.consensus.timeout_commit = 0.0
            cfg.consensus.skip_timeout_commit = True
            cfg.consensus.peer_gossip_sleep_duration = 0.005
            cfg.consensus.peer_query_maj23_sleep_duration = 0.25
            cfg.instrumentation.loop_probe_interval = 0.02
            cfg.instrumentation.watchdog_interval = 0.25
            cfg.instrumentation.watchdog_stall_seconds = 3.0
        elif args.db_backend:
            cfg.base.db_backend = args.db_backend
        if chaos:
            # chaos rig: fault layer + guarded control routes on every
            # node; node --twin becomes a double-signer from genesis
            cfg.chaos.enabled = True
            cfg.chaos.seed = getattr(args, "chaos_seed", 0)
            cfg.chaos.twin = i == twin
            cfg.rpc.unsafe = True
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


def cmd_trace(args) -> int:
    """Dump a running node's flight recorder (libs/tracing.py) via the
    dump_flight_recorder RPC route.  Default output is a human timeline
    (relative ms since the oldest event); --json emits the raw snapshot;
    --check exits 1 unless every fully-recorded block has a complete
    propose→commit span chain."""
    from .libs import tracing
    from .rpc.client import HTTPClient

    async def fetch() -> dict:
        async with HTTPClient(args.rpc_laddr) as c:
            return await c._call("dump_flight_recorder", {"since": args.since})

    snap = asyncio.run(fetch())
    events = snap.get("events", [])
    if args.net_budget:
        # cross-node stage budget from THIS node's events alone: proposal
        # propagation, part-stream completion, vote fan-in to quorum, and
        # hop-count/latency distributions (wire-level trace context)
        budget = tracing.net_budget(events)
        if args.json:
            print(json.dumps({"net_budget": budget}))
        else:
            print(tracing.format_net_budget(budget))
        return 0 if budget is not None else 1
    if args.budget:
        # per-stage latency budget: propose→prevote→precommit→
        # commit(persist)→finalize(deliver)→next-propose + c2c percentiles
        budget = tracing.stage_budget(events)
        if args.json:
            print(json.dumps({"budget": budget}))
        else:
            print(tracing.format_budget(budget))
        return 0 if budget is not None else 1
    if args.json:
        print(json.dumps(snap))
    else:
        print(
            f"flight recorder: enabled={snap.get('enabled')} size={snap.get('size')} "
            f"next_seq={snap.get('next_seq')} dropped={snap.get('dropped')} "
            f"events={len(events)}"
        )
        t0 = events[0]["t_ns"] if events else 0
        for ev in events:
            fields = " ".join(
                f"{k}={v}" for k, v in ev.items() if k not in ("seq", "t_ns", "kind")
            )
            print(f"+{(ev['t_ns'] - t0) / 1e6:12.3f}ms  {ev['kind']:<22} {fields}")
    if args.check:
        # ring wrap / startup truncate edge heights trivially; a BUSY ring
        # can also age out the early steps of interior heights (prefix-
        # missing = `truncated`, reported but not fatal — hard-failing
        # there made --check useless exactly on the nets it is for).
        # Only a mid-chain hole (a later step present while an earlier one
        # is missing) is a real failure.
        rep = tracing.span_report(
            events, dropped=snap.get("dropped", 0), since=args.since
        )
        if rep["interior"] < 1 or rep["bad"] or not (
            rep["complete"] or rep["truncated"]
        ):
            print(
                f"trace check FAILED: {rep['interior']} interior heights, "
                f"complete={len(rep['complete'])} truncated={len(rep['truncated'])} "
                f"broken chains: {rep['bad']}",
                file=sys.stderr,
            )
            return 1
        msg = f"trace check ok: {len(rep['complete'])} blocks with complete span chains"
        if rep["truncated"]:
            msg += f" ({len(rep['truncated'])} truncated by ring wrap)"
        print(msg)
        dropped = snap.get("dropped", 0)
        if dropped:
            # silent span loss is exactly what the forensics layer exists
            # to prevent — surface it here AND as the
            # tendermint_recorder_dropped_total gauge
            print(
                f"warning: {dropped} events already evicted from the ring "
                "(raise [instrumentation] flight_recorder_size, sample "
                "high-rate kinds, or enable flight_spool to persist them)"
            )
    return 0


def cmd_trace_net(args) -> int:
    """Merge N nodes' flight-recorder dumps (libs/tracemerge.py) into one
    network-wide per-height timeline — proposal born → part coverage →
    per-node maj23 → commit skew — plus each node's scheduler-profiler
    block attribution.  Dumps come from files (a `trace --json` or
    `debug dump` recorder.json, or a flight spool) or live via --rpc;
    --check applies the gate (complete aligned timelines, nonzero attribution
    for every interior block)."""
    from .libs import tracemerge

    dumps = []
    for path in args.dumps:
        dumps.append(tracemerge.load_dump(path))
    if args.rpc:
        from .rpc.client import HTTPClient

        async def fetch(laddr: str) -> dict:
            async with HTTPClient(laddr) as c:
                return await c._call("dump_flight_recorder", {})

        for laddr in args.rpc.split(","):
            snap = asyncio.run(fetch(laddr))
            snap.setdefault("node", laddr)
            dumps.append(snap)
    if not dumps:
        print("no dumps given (paths or --rpc)", file=sys.stderr)
        return 2
    merged = tracemerge.merge(dumps, causal=not args.no_causal_align)
    if args.json:
        out = {
            "merged": merged,
            "attribution": {
                d.get("node"): tracemerge.median_attribution(
                    tracemerge.attribution_by_height(d)
                )
                for d in dumps
            },
        }
        if args.check:
            out["failures"] = tracemerge.check(
                dumps, merged, require_attribution=not args.no_attribution
            )
        print(json.dumps(out))
        return 1 if args.check and out.get("failures") else 0
    heights = [args.height] if args.height else None
    print(tracemerge.format_timeline(merged, heights))
    print(tracemerge.format_attribution(dumps))
    if args.check:
        failures = tracemerge.check(
            dumps, merged, require_attribution=not args.no_attribution
        )
        if failures:
            print("trace-net check FAILED:", file=sys.stderr)
            for f in failures:
                print(f"  - {f}", file=sys.stderr)
            return 1
        print(f"trace-net check ok: {len(merged['heights'])} heights aligned "
              f"across {len(dumps)} nodes")
    return 0


def cmd_version(args) -> int:
    from . import version

    print(version.VERSION)
    return 0


async def _debug_rpc_sections(rpc_laddr: str) -> dict:
    """The live half of a debug bundle: every introspection route a
    running node serves, each independently fallible (an unsafe route
    gated off — or a node wedged enough that one handler hangs — must not
    sink the rest of the bundle)."""
    from .rpc.client import HTTPClient

    sections = {}
    async with HTTPClient(rpc_laddr) as c:
        for name, method, params in (
            ("status", "status", {}),
            ("net_info", "net_info", {}),
            ("consensus_state", "dump_consensus_state", {}),
            ("recorder", "dump_flight_recorder", {}),
            ("health", "health", {}),
            ("storage", "storage_info", {}),
            ("tasks", "unsafe_dump_tasks", {}),
        ):
            try:
                sections[name] = await asyncio.wait_for(c._call(method, params), 10.0)
            except Exception as e:  # noqa: BLE001 — per-section degradation
                sections[name] = {"error": repr(e)}
    return sections


def _scrape_metrics(listen_addr: str) -> "bytes | None":
    """One prometheus exposition scrape for the bundle (best effort)."""
    import urllib.request

    host, _, port = listen_addr.split("://")[-1].rpartition(":")
    url = f"http://{host or '127.0.0.1'}:{port}/metrics"
    try:
        with urllib.request.urlopen(url, timeout=3) as r:
            return r.read()
    except Exception:
        return None


def _tail_file(path: str, n: int = 65536) -> "bytes | None":
    try:
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            size = f.tell()
            f.seek(max(0, size - n))
            return f.read()
    except OSError:
        return None


def _sanitized_config_text(path: str) -> "str | None":
    """config.toml for the bundle with secret-shaped values redacted.
    The config holds no key material today (keys live in their own
    files, which a bundle NEVER touches) — the redaction is the
    guarantee that stays true if a token-bearing knob ever lands."""
    try:
        with open(path) as f:
            lines = f.readlines()
    except OSError:
        return None
    out = []
    for line in lines:
        key = line.split("=", 1)[0].strip().lower()
        if "=" in line and any(s in key for s in ("secret", "password", "token")):
            out.append(f"{line.split('=', 1)[0]}= \"<redacted>\"\n")
        else:
            out.append(line)
    return "".join(out)


def _offline_storage_section(cfg) -> dict:
    """The storage section of a bundle built from the HOME DIR ALONE — a
    disk-sick node is exactly the node most likely to be dead by the time
    the bundle is taken.  Per-store disk usage, WAL/spool chunk counts,
    free space, and a bounded read-only integrity scan of the block store
    so an offline bundle SHOWS the rot that killed the node.  Shares the
    walk helpers with the live `storage_info` route so both modes stay
    field-compatible."""
    from .libs.autofile import dir_usage, group_disk_stats

    out: dict = {"mode": "offline"}
    db_dir = cfg.db_dir()
    out["disk_usage"] = dir_usage(db_dir)
    try:
        st = os.statvfs(db_dir)
        out["free_bytes"] = st.f_bavail * st.f_frsize
    except OSError:
        out["free_bytes"] = None
    wals = {}
    for label, head in (
        ("consensus_wal", cfg.wal_file()),
        ("mempool_wal", os.path.join(cfg.mempool_wal_dir(), "wal") if cfg.mempool.wal_dir else ""),
        ("flight_spool", cfg.flight_spool_file()),
    ):
        stats = group_disk_stats(head) if head else None
        if stats is not None:
            wals[label] = stats
    out["wals"] = wals
    # read-only integrity sweep of the dead node's block store (sqlite
    # only; bounded — a forensics bundle is not the place for an archive
    # scan).  Every failure degrades to an error note, never sinks the
    # bundle.
    bs_path = os.path.join(db_dir, "blockstore.db")
    if os.path.exists(bs_path):
        try:
            from .libs.kvstore import SQLiteDB
            from .store import BlockStore

            db = SQLiteDB(bs_path)
            try:
                store = BlockStore(db)
                out["integrity_scan"] = store.integrity_scan(limit=64)
            finally:
                db.close()
        except Exception as e:  # noqa: BLE001 — per-section degradation
            out["integrity_scan"] = {"error": repr(e)}
    return out


def _build_debug_bundle(home: str, rpc_laddr: str, offline: bool) -> dict:
    """Assemble every section of a forensics bundle as {filename: bytes}.

    Live sections come from the node's RPC; home-dir sections (sanitized
    config, consensus/mempool WAL tails, the crash spool replay) need
    only the disk — so the SAME command produces a useful bundle from a
    node that is already dead (`--offline`, or RPC simply unreachable).
    The span/loop reports are derived from the best available event
    stream: the live recorder when reachable, else the on-disk spool —
    a SIGKILLed node's pre-crash step chains reconstruct from the spool
    alone."""
    from .libs import tracemerge, tracing

    home = os.path.expanduser(home)
    cfg = _load_cfg(home)
    files: dict = {}
    manifest: dict = {
        "created_unix": int(time.time()),
        "home": home,
        "mode": "offline" if offline else "live",
        "sections": [],
    }

    rpc_sections: dict = {}
    if not offline:
        try:
            rpc_sections = asyncio.run(_debug_rpc_sections(rpc_laddr))
        except Exception as e:  # node down: degrade to the home dir
            manifest["rpc_error"] = repr(e)
            rpc_sections = {}
        for name, obj in rpc_sections.items():
            files[f"{name}.json"] = json.dumps(obj, indent=1, default=repr).encode()
        if rpc_sections and cfg.instrumentation.prometheus:
            prom = _scrape_metrics(cfg.instrumentation.prometheus_listen_addr)
            if prom is not None:
                files["metrics.prom"] = prom

    cfg_text = _sanitized_config_text(
        os.path.join(home, "config", "config.toml")
    )
    if cfg_text is not None:
        files["config.toml"] = cfg_text.encode()
    wal_tail = _tail_file(cfg.wal_file())
    if wal_tail is not None:
        files["cs_wal.tail"] = wal_tail
    if cfg.mempool.wal_dir:
        mwal = _tail_file(os.path.join(cfg.mempool_wal_dir(), "wal"))
        if mwal is not None:
            files["mempool_wal.tail"] = mwal

    # storage section: the live storage_info route when it answered, else
    # rebuilt offline from the home dir (incl. a bounded integrity scan —
    # a bundle from a disk-sick node must show WHY it died)
    live_storage = rpc_sections.get("storage")
    if not isinstance(live_storage, dict) or "error" in live_storage:
        try:
            files["storage.json"] = json.dumps(
                _offline_storage_section(cfg), indent=1, default=repr
            ).encode()
        except Exception as e:  # noqa: BLE001 — per-section degradation
            files["storage.json"] = json.dumps({"error": repr(e)}).encode()

    # the crash spool: raw tail for byte-level forensics plus the torn-
    # tail-tolerant replay as a dump-shaped JSON trace-net can merge
    spool_path = cfg.flight_spool_file()
    spool_dump = None
    if tracing.spool_paths(spool_path):
        raw = _tail_file(spool_path, 1 << 20)
        if raw is not None:
            files["flight.spool.tail"] = raw
        # the spool's own anchor records the writing node's name; the
        # config moniker is only the fallback for a nameless spool
        spool_dump = tracing.read_spool(spool_path)
        if not spool_dump.get("node"):
            spool_dump["node"] = cfg.base.moniker
        files["spool.json"] = json.dumps(spool_dump, default=repr).encode()

    # derived reports from the best event source available (the already-
    # decoded RPC section — no reason to re-parse megabytes of events we
    # just serialized)
    src = None
    rec = rpc_sections.get("recorder")
    if isinstance(rec, dict) and rec.get("events"):
        src = rec
    if src is None and spool_dump is not None and spool_dump["events"]:
        src = spool_dump
    if src is not None:
        events = src["events"]
        files["span_report.json"] = json.dumps(
            tracing.span_report(
                events, dropped=src.get("dropped", 0), since=src.get("since", 0)
            )
        ).encode()
        files["loop_report.json"] = json.dumps(
            {
                "block_breakdown": tracing.block_breakdown(events),
                "attribution_by_height": tracemerge.attribution_by_height(dict(src)),
            },
            default=repr,
        ).encode()
        manifest["event_source"] = src.get("source", "recorder")
        manifest["events"] = len(events)

    manifest["sections"] = sorted(files)
    files["manifest.json"] = json.dumps(manifest, indent=1).encode()
    return files


def _write_debug_bundle(files: dict, out_path: str) -> str:
    import io
    import tarfile

    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    prefix = os.path.basename(out_path).split(".tar")[0]
    with tarfile.open(out_path, "w:gz") as tar:
        for name in sorted(files):
            data = files[name]
            info = tarfile.TarInfo(f"{prefix}/{name}")
            info.size = len(data)
            info.mtime = int(time.time())
            tar.addfile(info, io.BytesIO(data))
    return out_path


def cmd_debug_dump(args) -> int:
    """commands/debug/dump.go — one timestamped forensics bundle
    (status, net_info, consensus dump, flight-recorder snapshot, health,
    task dump, metrics scrape, sanitized config, WAL tails, crash-spool
    replay and derived span/loop reports) as a tar.gz; `--frequency N`
    takes periodic bundles.  Works OFFLINE from a home directory when the
    node is already dead — the spool replay stands in for the live
    recorder."""
    interval = args.frequency if args.frequency > 0 else args.interval
    forever = interval > 0 and args.count <= 0
    i = 0
    try:
        while forever or i < max(args.count, 1):
            files = _build_debug_bundle(args.home, args.rpc_laddr, args.offline)
            out = os.path.join(
                os.path.abspath(args.output), f"bundle_{i}_{int(time.time())}.tar.gz"
            )
            _write_debug_bundle(files, out)
            print(f"wrote {out} ({len(files)} sections)")
            i += 1
            more = forever or i < args.count
            if interval > 0 and more:
                time.sleep(interval)
            elif not more:
                break
    except KeyboardInterrupt:
        # Ctrl-C is the documented exit for --frequency with no --count —
        # and building a bundle against a WEDGED node can block for up to
        # a minute of per-section timeouts, which is exactly when an
        # operator interrupts; exit cleanly with whatever is on disk
        pass
    return 0


def cmd_debug_watch(args) -> int:
    """Live fleet telescope (tools/telescope.py): continuously poll every
    node's flight recorder / health / status with per-node watermarks,
    live-merge the rolling window into one network timeline (measured
    skew when peers speak the wire trace tier), and render a refreshing
    fleet-health dashboard — tip spread, per-node lag, quorum latency,
    hop latencies, stalled part streams.  Survives nodes dying mid-run:
    every per-node poll is independently fallible, dead nodes stay on
    the board marked DOWN while the survivors' timeline keeps merging."""
    from .tools.telescope import Telescope

    targets = [t for t in args.rpc.split(",") if t]
    if not targets:
        print("no targets given (--rpc host:port,host:port,...)", file=sys.stderr)
        return 2
    tele = Telescope(
        targets,
        interval=args.interval,
        window=args.window,
        serve_addr=args.serve or None,
    )
    try:
        if args.once:
            asyncio.run(tele.run(cycles=1, dashboard=False))
            print(json.dumps(tele.last_snapshot, default=repr))
            return 0
        asyncio.run(
            tele.run(
                cycles=args.cycles if args.cycles > 0 else None,
                dashboard=not args.json,
                json_lines=args.json,
            )
        )
    except KeyboardInterrupt:
        pass
    return 0


def cmd_debug_kill(args) -> int:
    """commands/debug/kill.go — capture a bundle from the running node,
    then SIGKILL its pid: the evidence is on disk BEFORE the process
    dies, and the spool/WAL tails show its final moments."""
    files = _build_debug_bundle(args.home, args.rpc_laddr, offline=False)
    out = args.output or f"debug_kill_{args.pid}_{int(time.time())}.tar.gz"
    _write_debug_bundle(files, os.path.abspath(out))
    print(f"wrote {os.path.abspath(out)} ({len(files)} sections)")
    try:
        os.kill(args.pid, signal.SIGKILL)
        print(f"killed pid {args.pid}")
    except OSError as e:
        print(f"kill {args.pid} failed: {e}", file=sys.stderr)
        return 1
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
        "(bls12381 unlocks aggregate commits)",
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
    sp.add_argument(
        "--chaos",
        action="store_true",
        help="chaos rig: enable the fault-injection layer and the unsafe "
        "chaos control RPC routes on every node",
    )
    sp.add_argument(
        "--chaos-seed", type=int, default=0,
        help="seed for every probabilistic fault decision (replayable runs)",
    )
    sp.add_argument(
        "--twin", type=int, default=-1,
        help="node index to run as a double-signing twin (requires --chaos)",
    )
    sp.add_argument(
        "--key-type", choices=list(KEY_TYPES), default="ed25519",
        help="consensus key scheme for every generated validator key; "
        "bls12381 genesis validators carry proofs of possession and the "
        "net commits blocks with ONE aggregate signature per commit",
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

    sp = sub.add_parser(
        "debug", help="capture forensics bundles from a running (or dead) node"
    )
    dsub = sp.add_subparsers(dest="debug_cmd", required=True)
    dp = dsub.add_parser(
        "dump",
        help="write a tar.gz forensics bundle (status/consensus/recorder/"
        "health/metrics/config/WAL+spool tails); works offline from --home "
        "when the node is dead",
    )
    dp.add_argument("--rpc-laddr", default="127.0.0.1:26657")
    dp.add_argument("--output", default="debug_dump")
    dp.add_argument(
        "--interval", type=float, default=0.0, help="seconds between dumps (0 = one dump)"
    )
    dp.add_argument(
        "--frequency", type=float, default=0.0,
        help="reference-parity alias for --interval (takes precedence when set)",
    )
    dp.add_argument(
        "--count",
        type=int,
        default=0,
        help="number of dumps; 0 with an interval > 0 = until interrupted",
    )
    dp.add_argument(
        "--offline", action="store_true",
        help="skip the RPC entirely: build the bundle from the home dir "
        "(sanitized config, WAL tails, crash-spool replay) — the dead-node path",
    )
    dp.set_defaults(fn=cmd_debug_dump)
    dp = dsub.add_parser(
        "watch",
        help="live fleet telescope: poll every node's recorder/health/"
        "status, live-merge a rolling network timeline with measured "
        "clock skew, render a refreshing fleet-health dashboard",
    )
    dp.add_argument(
        "--rpc", required=True,
        help="comma-separated node RPC laddrs (host:port,host:port,...)",
    )
    dp.add_argument(
        "--interval", type=float, default=1.0, help="seconds between poll sweeps"
    )
    dp.add_argument(
        "--window", type=int, default=5000,
        help="rolling per-node event-buffer size (oldest evicted first)",
    )
    dp.add_argument(
        "--serve", default="",
        help="host:port for the JSON snapshot endpoint (GET /snapshot)",
    )
    dp.add_argument(
        "--cycles", type=int, default=0,
        help="stop after N poll sweeps (0 = run until interrupted)",
    )
    dp.add_argument(
        "--once", action="store_true",
        help="one poll sweep, print the JSON snapshot, exit",
    )
    dp.add_argument(
        "--json", action="store_true",
        help="emit one JSON snapshot line per sweep instead of the dashboard",
    )
    dp.set_defaults(fn=cmd_debug_watch)
    dp = dsub.add_parser(
        "kill", help="capture a bundle from the node, then SIGKILL its pid"
    )
    dp.add_argument("pid", type=int, help="pid of the node process")
    dp.add_argument("--rpc-laddr", default="127.0.0.1:26657")
    dp.add_argument(
        "--output", default="",
        help="bundle path (default debug_kill_<pid>_<ts>.tar.gz)",
    )
    dp.set_defaults(fn=cmd_debug_kill)

    sp = sub.add_parser("trace", help="dump a running node's flight recorder")
    sp.add_argument("--rpc-laddr", default="127.0.0.1:26657")
    sp.add_argument("--since", type=int, default=0, help="seq watermark (previous next_seq)")
    sp.add_argument("--json", action="store_true", help="raw snapshot JSON")
    sp.add_argument(
        "--check",
        action="store_true",
        help="exit 1 unless every fully-recorded block has a complete propose→commit chain",
    )
    sp.add_argument(
        "--budget",
        action="store_true",
        help="per-stage latency budget table (propose→…→finalize→next-propose)",
    )
    sp.add_argument(
        "--net-budget",
        action="store_true",
        help="cross-node stage budget from this node's gossip.hop events: "
        "proposal propagation, part-stream completion, vote fan-in to "
        "quorum, hop-count/latency distributions",
    )
    sp.set_defaults(fn=cmd_trace)

    sp = sub.add_parser(
        "trace-net",
        help="merge N nodes' recorder dumps into one causal network timeline",
    )
    sp.add_argument("dumps", nargs="*", help="recorder dump JSON files")
    sp.add_argument(
        "--rpc", default="",
        help="comma-separated RPC laddrs to dump live (host:port,...)",
    )
    sp.add_argument("--height", type=int, default=0, help="show one height only")
    sp.add_argument("--json", action="store_true", help="machine-readable output")
    sp.add_argument(
        "--check", action="store_true",
        help="exit 1 unless timelines are complete and aligned with nonzero "
        "attribution for every interior block",
    )
    sp.add_argument(
        "--no-causal-align", action="store_true",
        help="trust the anchors verbatim (skip commit-landmark offset correction)",
    )
    sp.add_argument(
        "--no-attribution", action="store_true",
        help="with --check: don't require scheduler-profiler attribution",
    )
    sp.set_defaults(fn=cmd_trace_net)

    sp = sub.add_parser("version", help="print version")
    sp.set_defaults(fn=cmd_version)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
