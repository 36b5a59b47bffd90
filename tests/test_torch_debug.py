"""The port's forensics commands (tendermint_tpu_torch/cli.py `trace`,
`trace-net`, `debug dump`, `debug kill`, `debug watch`) against the JAX
CLI's, tolerance exact.

- `trace` (its timeline, `--check`, `--json`, `--budget`, `--net-budget`,
  `--since`) and `trace-net` (`--rpc`, dump files, `--check`, `--json`,
  `--height`, `--no-causal-align`, `--no-attribution`) print the same
  lines and return the same exit codes as the JAX CLI against the same
  in-process port nodes (two validators, `device="cpu"`, RPC on free
  ports, the flight spool on), held still for the comparison: consensus
  stopped, recorders off, the recorders' monotonic and wall anchors fixed.
- `debug dump --offline` on a port home (a crashed spool; a node's sqlite
  home) writes the JAX bundle's sections, and its deterministic sections
  are byte-equal to the JAX package's `_build_debug_bundle` on the same
  home (storage.json but for free space and the scan's ms, manifest.json
  but for its creation time).  A live bundle holds the JAX section set; a
  dead RPC degrades to the home directory as in JAX; `--count` with
  `--frequency` writes that many bundles.
- `debug kill` writes its bundle, then SIGKILLs a stand-in child.
- `debug watch --once` prints the JAX snapshot (but for `t_unix`).
- `trace`, `trace-net` and `debug` leave torch out of sys.modules.
"""

import asyncio
import contextlib
import io
import json
import os
import subprocess
import sys
import tarfile
import threading
import types

import pytest

from tendermint_tpu import cli as jcli
from tendermint_tpu_torch import cli as pcli
from tendermint_tpu_torch.libs import tracing as ptracing

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MONO_NS, WALL_NS = 5_000_000_000_000, 1_700_000_000_000_000_000


def run_cli(main, argv):
    """One CLI call with its stdout and stderr captured: (rc, out, err)."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(list(argv))
    return rc, out.getvalue(), err.getvalue()


def both(argv):
    """The same command through each CLI: equal exit codes and lines."""
    port, jax_ = run_cli(pcli.main, argv), run_cli(jcli.main, argv)
    assert port == jax_, argv
    return port


@pytest.fixture(scope="module")
def held_net(tmp_path_factory):
    """Two port validators run to height 5 on a loop in a thread, then held
    still: recorders off, consensus stopped, anchors fixed."""
    import test_torch_net as tnet
    import test_torch_tracemerge as tm

    from tendermint_tpu_torch.config import save_config

    tmp = tmp_path_factory.mktemp("debug-net")
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()

    def run(coro, timeout=120.0):
        return asyncio.run_coroutine_threadsafe(coro, loop).result(timeout)

    nodes = tm.port_net_nodes(tmp, n=2, name="dbg", rpc=True, spool=True)
    for n in nodes:  # the bundles' config.toml
        n.config.ensure_dirs()
        save_config(n.config, os.path.join(n.config.home, "config", "config.toml"))

    async def up():
        for n in nodes:
            await n.start()
        await tnet._mesh(nodes)
        await tnet._wait_height(nodes, 5, 60.0)
        for n in nodes:
            n.flight_recorder.enabled = False
            n.flight_recorder._wall_ns_fn = lambda: WALL_NS
        for n in nodes:
            await n.consensus.stop()
        for n in nodes:
            n.flight_spool.flush()

    mp = pytest.MonkeyPatch()
    try:
        run(up())
        mp.setattr(ptracing, "time", types.SimpleNamespace(monotonic_ns=lambda: MONO_NS))
        yield types.SimpleNamespace(
            nodes=nodes, run=run, rpc=[n.rpc_server.listen_addr for n in nodes],
            homes=[n.config.home for n in nodes], tmp=tmp)
    finally:
        mp.undo()
        run(tnet._stop(nodes))
        loop.call_soon_threadsafe(loop.stop)
        thread.join(10)
        loop.close()


TRACE = {
    "timeline": (),
    "check": ("--check",),
    "json": ("--json",),
    "budget": ("--budget",),
    "budget_json": ("--budget", "--json"),
    "net_budget": ("--net-budget",),
    "net_budget_json": ("--net-budget", "--json"),
    "since_check": ("--since", "40", "--check"),
}


@pytest.mark.parametrize("case", sorted(TRACE))
def test_trace_equals_jax(held_net, case):
    rc, out, err = both(["trace", "--rpc-laddr", held_net.rpc[0], *TRACE[case]])
    if case in ("check", "since_check"):
        assert rc == 0 and "trace check ok: " in out
    if case == "budget":
        assert rc == 0 and out.startswith("latency budget over ")
    if case == "json":
        assert json.loads(out)["node"] == "dbg0"


TRACE_NET = {
    "timeline": (),
    "check": ("--check",),
    "json": ("--json",),
    "check_json": ("--check", "--json"),
    "height": ("--height", "3"),
    "no_causal_align": ("--no-causal-align",),
    "no_attribution": ("--check", "--no-attribution"),
}


@pytest.mark.parametrize("case", sorted(TRACE_NET))
def test_trace_net_over_rpc_equals_jax(held_net, case):
    rc, out, err = both(["trace-net", "--rpc", ",".join(held_net.rpc), *TRACE_NET[case]])
    assert rc == 0
    if case == "check":
        assert "heights aligned across 2 nodes" in out


def test_trace_net_over_files_and_without_dumps_equals_jax(held_net, tmp_path):
    paths = []
    for i, rpc in enumerate(held_net.rpc):
        rc, out, _ = both(["trace", "--rpc-laddr", rpc, "--json"])
        paths.append(str(tmp_path / f"n{i}.json"))
        with open(paths[-1], "w") as f:
            f.write(out)
    spool = os.path.join(held_net.homes[1], "data", "flight.spool")
    for argv in (paths + ["--check"], [paths[0], spool, "--check", "--json"]):
        rc, out, err = both(["trace-net", *argv])
        assert rc == 0
    assert both(["trace-net"]) == (2, "", "no dumps given (paths or --rpc)\n")


def test_debug_watch_once_equals_jax(held_net):
    argv = ["debug", "watch", "--once", "--rpc", ",".join(held_net.rpc)]
    port, jax_ = run_cli(pcli.main, argv), run_cli(jcli.main, argv)
    snaps = []
    for rc, out, err in (port, jax_):
        assert rc == 0
        snap = json.loads(out)
        del snap["t_unix"]
        snaps.append(snap)
    assert snaps[0] == snaps[1]
    assert [n["alive"] for n in snaps[0]["nodes"]] == [True, True]
    assert snaps[0]["fleet"]["tip_spread"] == 0


def bundle(path):
    with tarfile.open(path) as tar:
        return {os.path.basename(m.name): tar.extractfile(m).read() for m in tar.getmembers()}


def only_bundle(directory):
    names = [n for n in os.listdir(directory) if n.endswith(".tar.gz")]
    assert len(names) == 1, names
    return bundle(os.path.join(directory, names[0]))


# the JAX live bundle of a memdb node (no WAL files) without a mempool WAL
LIVE_SECTIONS = {"status.json", "net_info.json", "consensus_state.json", "recorder.json",
                 "health.json", "storage.json", "tasks.json", "config.toml",
                 "flight.spool.tail", "spool.json", "span_report.json", "loop_report.json",
                 "manifest.json"}
HELD = ("recorder.json", "spool.json", "flight.spool.tail", "span_report.json",
        "loop_report.json", "config.toml")


def test_debug_dump_live_holds_the_jax_sections(held_net, tmp_path):
    home, rpc = held_net.homes[0], held_net.rpc[0]
    rc, out, _ = run_cli(pcli.main, ["--home", home, "debug", "dump", "--rpc-laddr", rpc,
                                     "--output", str(tmp_path / "port")])
    assert rc == 0 and out.startswith("wrote ") and out.endswith(" sections)\n")
    port = only_bundle(tmp_path / "port")
    jax_ = jcli._build_debug_bundle(home, rpc, offline=False)
    assert set(port) == set(jax_) == LIVE_SECTIONS
    for name in HELD:
        assert port[name] == jax_[name], name
    assert "error" in json.loads(port["tasks.json"])  # unsafe routes are gated off
    manifest = json.loads(port["manifest.json"])
    assert manifest["mode"] == "live" and manifest["event_source"] == "recorder"


def test_debug_kill_writes_its_bundle_then_kills(held_net, tmp_path):
    child = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(120)"])
    try:
        out_path = str(tmp_path / "kill.tar.gz")
        rc, out, _ = run_cli(pcli.main, ["--home", held_net.homes[1], "debug", "kill",
                                         str(child.pid), "--rpc-laddr", held_net.rpc[1],
                                         "--output", out_path])
        assert child.wait(30) == -9
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    assert rc == 0 and out.splitlines() == [f"wrote {out_path} ({len(LIVE_SECTIONS)} sections)",
                                            f"killed pid {child.pid}"]
    assert set(bundle(out_path)) == LIVE_SECTIONS
    # a pid that is gone: the bundle is written, the kill fails with exit 1
    rc, out, err = run_cli(pcli.main, ["--home", held_net.homes[1], "debug", "kill",
                                       str(child.pid), "--rpc-laddr", held_net.rpc[1],
                                       "--output", str(tmp_path / "again.tar.gz")])
    assert rc == 1 and err.startswith(f"kill {child.pid} failed: ")


def crashed_home(tmp_path, heights=6):
    """A port `init` home whose flight spool was flushed per height and
    never closed (the JAX test's dead node)."""
    from tendermint_tpu_torch.config import load_config

    home = str(tmp_path / "home")
    assert run_cli(pcli.main, ["--home", home, "init", "--chain-id", "dbg-chain"])[0] == 0
    cfg = load_config(os.path.join(home, "config", "config.toml"), home=home)
    rec = ptracing.FlightRecorder(size=8192)
    sp = ptracing.FlightSpool(cfg.flight_spool_file(), rec, node="dbg-node")
    for h in range(1, heights + 1):
        for s in ("Propose", "Prevote", "Precommit", "Commit"):
            rec.record("step", height=h, round=0, step=s)
        rec.record("commit", height=h, txs=0, block=f"h{h}")
        sp.flush()
    return home


def assert_offline_equal(port, jax_):
    assert set(port) == set(jax_)
    for name in set(port) - {"storage.json", "manifest.json"}:
        assert port[name] == jax_[name], name
    st = [json.loads(b[name]) for b in (port, jax_) for name in ("storage.json",)]
    for s in st:
        s.pop("free_bytes")
        if isinstance(s.get("integrity_scan"), dict):
            s["integrity_scan"].pop("ms", None)
    assert st[0] == st[1]
    mf = [json.loads(b["manifest.json"]) for b in (port, jax_)]
    for m in mf:
        m.pop("created_unix")
    assert mf[0] == mf[1]


def test_debug_dump_offline_replays_the_spool_as_jax(tmp_path):
    home = crashed_home(tmp_path)
    out = str(tmp_path / "bundles")
    rc, text, _ = run_cli(pcli.main, ["--home", home, "debug", "dump", "--offline",
                                      "--output", out])
    assert rc == 0
    port = only_bundle(out)
    assert_offline_equal(port, jcli._build_debug_bundle(home, "", offline=True))
    assert {"manifest.json", "config.toml", "spool.json", "span_report.json",
            "loop_report.json", "flight.spool.tail", "storage.json"} == set(port)
    manifest = json.loads(port["manifest.json"])
    assert manifest["mode"] == "offline" and manifest["event_source"] == "spool"
    rep = json.loads(port["span_report.json"])
    assert rep["bad"] == {} and rep["interior"] == 4 == len(rep["complete"])
    assert json.loads(port["spool.json"])["node"] == "dbg-node"


async def test_debug_dump_offline_of_a_node_home_equals_jax(tmp_path):
    """A solo port node on sqlite stores with the spool on, stopped with its
    spool dropped unflushed: the offline bundle (WAL tails, the integrity
    scan of its block store, the replay) equals the JAX package's."""
    from tendermint_tpu_torch.config import load_config
    from tendermint_tpu_torch.node import default_new_node

    home = str(tmp_path / "solo")
    assert run_cli(pcli.main, ["--home", home, "init", "--chain-id", "dbg-solo"])[0] == 0
    path = os.path.join(home, "config", "config.toml")
    cfg = load_config(path, home=home)
    cfg.p2p.laddr, cfg.rpc.laddr = "none", ""
    cfg.instrumentation.flight_spool = True
    cfg.mempool.wal_dir = "data/mempool.wal"
    cfg.consensus.timeout_commit = 0.05
    from tendermint_tpu_torch.config import save_config

    save_config(cfg, path)
    node = default_new_node(load_config(path, home=home), device="cpu")
    await node.start()
    try:
        while node.block_store.height() < 3:
            await asyncio.sleep(0.02)
        sp = node.flight_spool
        sp.flush()
        with sp._lock:  # the SIGKILL: nothing after the last cadence flush
            sp._closed = True
    finally:
        await node.stop()
    out = str(tmp_path / "bundles")
    assert (await asyncio.to_thread(run_cli, pcli.main, ["--home", home, "debug", "dump",
                                                          "--offline", "--output", out]))[0] == 0
    port = only_bundle(out)
    assert_offline_equal(port, await asyncio.to_thread(jcli._build_debug_bundle, home, "", True))
    assert {"cs_wal.tail", "mempool_wal.tail", "spool.json"} <= set(port)
    storage = json.loads(port["storage.json"])
    assert storage["integrity_scan"]["checked"] >= 3 and storage["integrity_scan"]["corrupt"] == []


def test_debug_dump_periodic_count(tmp_path):
    home = crashed_home(tmp_path, heights=3)
    out = str(tmp_path / "periodic")
    rc, text, _ = run_cli(pcli.main, ["--home", home, "debug", "dump", "--offline", "--output",
                                      out, "--frequency", "0.05", "--count", "2"])
    assert rc == 0 and len(text.splitlines()) == 2
    assert len([f for f in os.listdir(out) if f.endswith(".tar.gz")]) == 2


def test_debug_dump_degrades_to_the_home_when_rpc_is_dead(tmp_path):
    home = crashed_home(tmp_path, heights=3)
    out = str(tmp_path / "degraded")
    rc, _, _ = run_cli(pcli.main, ["--home", home, "debug", "dump", "--output", out,
                                   "--rpc-laddr", "127.0.0.1:1"])
    assert rc == 0
    port = only_bundle(out)
    jax_ = jcli._build_debug_bundle(home, "127.0.0.1:1", offline=False)
    assert set(port) == set(jax_) and {"spool.json", "config.toml"} <= set(port)
    assert json.loads(port["manifest.json"])["mode"] == "live"
    # each route holds its error, as in JAX; storage.json is rebuilt offline
    assert "error" in json.loads(port["status.json"])
    assert json.loads(port["storage.json"])["mode"] == "offline"


def test_forensics_commands_leave_torch_out(held_net, tmp_path):
    """In a fresh interpreter: trace, trace-net, debug dump --offline and
    debug watch run, and torch was never imported."""
    home = crashed_home(tmp_path, heights=3)
    argvs = [["trace", "--rpc-laddr", held_net.rpc[0], "--check"],
             ["trace-net", "--rpc", ",".join(held_net.rpc), "--check"],
             ["--home", home, "debug", "dump", "--offline", "--output", str(tmp_path / "b")],
             ["debug", "watch", "--once", "--rpc", ",".join(held_net.rpc)]]
    code = ("import sys\nfrom tendermint_tpu_torch.cli import main\n"
            f"rcs = [main(a) for a in {argvs!r}]\n"
            "print('RESULT', rcs, 'torch' in sys.modules)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=ROOT, timeout=120, env=dict(os.environ, PYTHONPATH=ROOT))
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "RESULT [0, 0, 0, 0] False"
