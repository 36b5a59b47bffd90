"""The port's CLI (tendermint_tpu_torch/cli.py, `python -m
tendermint_tpu_torch`) against the JAX package's: init, show_validator,
show_node_id, gen_validator, gen_node_key, unsafe_reset_all and version
give the same files and outputs (os.urandom and time.time_ns held fixed,
the home path written as <home>), each CLI reads the other's home, and
`replay` over one WAL replays the same number of records in both.  The
port's `node` on a machine without a card exits non-zero naming the
missing card; it never runs its engine on the CPU.  Tolerance: exact.
"""

import asyncio
import hashlib
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

import test_torch_node as tn
from tendermint_tpu import cli as jcli
from tendermint_tpu.consensus import replay_file as jreplay_file
from tendermint_tpu_torch import cli as pcli
from tendermint_tpu_torch.consensus import replay_file as preplay_file

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLIS = {"port": pcli.main, "jax": jcli.main}
T_NS = 1_700_000_000_123_456_789


def fixed_entropy(monkeypatch):
    """os.urandom from a counter-seeded SHA-512 stream, restarted per call
    of this function, and a fixed time.time_ns."""
    state = {"n": 0}

    def urandom(k):
        out = b""
        while len(out) < k:
            state["n"] += 1
            out += hashlib.sha512(b"cli-parity-%d" % state["n"]).digest()
        return out[:k]

    monkeypatch.setattr(os, "urandom", urandom)
    monkeypatch.setattr(time, "time_ns", lambda: T_NS)


def run(which, home, argv, capsys, monkeypatch):
    """One CLI command; returns (rc, stdout, stderr) with the home path
    written as <home>."""
    fixed_entropy(monkeypatch)
    capsys.readouterr()
    rc = CLIS[which](["--home", home] + argv)
    out, err = capsys.readouterr()
    return rc, out.replace(home, "<home>"), err.replace(home, "<home>")


def tree(home):
    """Every file under home: relative path -> bytes."""
    out = {}
    for root, _, files in os.walk(home):
        for f in files:
            p = os.path.join(root, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, home)] = fh.read()
    return out


SEQUENCES = {
    "init": [["init", "--chain-id", "cli-parity"]],
    "init_random_chain_id": [["init"]],
    "show_validator": [["init", "--chain-id", "c"], ["show_validator"]],
    "show_node_id": [["init", "--chain-id", "c"], ["show_node_id"]],
    "gen_node_key": [["gen_node_key"], ["gen_node_key"]],
    "gen_validator": [["gen_validator"]],
    "unsafe_reset_all": [["init", "--chain-id", "c"], ["unsafe_reset_all"]],
    "version": [["version"]],
    "missing_keys": [["show_validator"], ["show_node_id"]],
}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_command_outputs_and_files_equal_jax(name, tmp_path, capsys, monkeypatch):
    got = {}
    for which in CLIS:
        home = str(tmp_path / which)
        outs = [run(which, home, argv, capsys, monkeypatch) for argv in SEQUENCES[name]]
        got[which] = (outs, tree(home) if os.path.isdir(home) else None)
    assert got["port"] == got["jax"]
    outs, files = got["port"]
    if name == "init":
        assert outs[0] == (0, "Initialized node in <home> (chain_id=cli-parity)\n", "")
        assert sorted(files) == ["config/config.toml", "config/genesis.json",
                                 "config/node_key.json", "config/priv_validator_key.json",
                                 "data/priv_validator_state.json"]
    if name == "missing_keys":
        assert [rc for rc, _, _ in outs] == [1, 1]
        assert "run `init` first" in outs[0][2]
    if name == "unsafe_reset_all":
        assert outs[1] == (0, "Reset <home>/data\n", "")
        assert "data/priv_validator_state.json" not in files


def test_each_cli_reads_the_others_home(tmp_path, capsys, monkeypatch):
    homes = {}
    for which in CLIS:
        homes[which] = str(tmp_path / which)
        rc, _, _ = run(which, homes[which], ["init", "--chain-id", "cross"], capsys, monkeypatch)
        assert rc == 0
    capsys.readouterr()
    # a different key in the JAX home, so that reading the wrong home shows
    shutil.rmtree(homes["jax"])
    monkeypatch.undo()
    assert jcli.main(["--home", homes["jax"], "init", "--chain-id", "cross"]) == 0
    capsys.readouterr()
    for cmd in ("show_validator", "show_node_id"):
        seen = {}
        for reader in CLIS:
            for owner in CLIS:
                assert CLIS[reader](["--home", homes[owner], cmd]) == 0
                seen[(reader, owner)] = capsys.readouterr().out
        assert seen[("port", "jax")] == seen[("jax", "jax")]
        assert seen[("jax", "port")] == seen[("port", "port")]
        assert seen[("port", "port")] != seen[("jax", "jax")]


async def _wal_home(tmp_path):
    """A JAX node's home with a WAL that ends inside height 1: two
    validators at power 10 (ours and one that never votes), so the node
    proposes or waits, prevotes and stops without a commit."""
    home = str(tmp_path / "wal-home")
    tn.make_home(tn.JAX, home)
    ours, other = tn.keys(tn.JAX)
    gen = tn.jgenesis.GenesisDoc(tn.CHAIN, genesis_time_ns=tn.T0, validators=[
        tn.jgenesis.GenesisValidator(k.pub_key().address(), k.pub_key(), 10, f"v{i}")
        for i, k in enumerate((ours, other))])
    gen.save_as(os.path.join(home, "config", "genesis.json"))
    tickers = []
    node = tn.jnode.default_new_node(tn.load_cfg(tn.JAX, home))
    with tn.held_clock_and_ticker(tn.JAX, tickers):
        await node.start()
    try:
        ticker = tickers[-1]
        for step in (1, 3):  # NEW_HEIGHT, then PROPOSE when no proposal comes
            await tn.until(lambda: any(t.step == step for t in ticker.scheduled),
                           f"timeout step {step}")
            ticker.fire([t for t in ticker.scheduled if t.step == step][-1])
            await asyncio.sleep(0.05)
        await tn.until(lambda: node.consensus.rs.votes.prevotes(0).get_by_address(
            ours.pub_key().address()) is not None, "our prevote")
    finally:
        await node.stop()
    return home


async def test_replay_replays_the_same_records(tmp_path):
    home = await _wal_home(tmp_path)
    counts = {}
    for ns, mod, rf in ((tn.PORT, pcli, preplay_file), (tn.JAX, jcli, jreplay_file)):
        h = str(tmp_path / f"replay-{ns.name}")
        shutil.copytree(home, h)
        cfg = mod._load_cfg(h)
        steps = iter(["2", "", "q"])
        # the replayed timeouts go to a MockTicker: the replay console
        # never starts its ConsensusState, so real timers would outlive it
        with tn.held_clock_and_ticker(ns, []):
            counts[ns.name] = await rf.run_replay_file(cfg)
            counts[ns.name + "-console"] = await rf.run_replay_file(
                cfg, console=True, input_fn=lambda prompt: next(steps))
    assert counts["port"] == counts["jax"] > 3
    assert counts["port-console"] == counts["jax-console"] == 3


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the behaviour without a card")
def test_port_node_command_without_a_card_exits_nonzero(tmp_path):
    home = str(tmp_path / "h")
    tn.make_home(tn.PORT, home)
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-m", "tendermint_tpu_torch", "--home", home, "node"],
                          capture_output=True, text=True, timeout=120, env=env, cwd=str(tmp_path))
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
    assert "node started" not in proc.stdout
    assert sorted(os.listdir(os.path.join(home, "data"))) == ["priv_validator_state.json"]


def test_replay_command_runs_in_both(tmp_path, capsys):
    home = str(tmp_path / "h")
    tn.make_home(tn.PORT, home)
    for main in CLIS.values():
        assert main(["--home", home, "replay"]) == 0
    assert {"blockstore.db", "state.db"} <= set(os.listdir(os.path.join(home, "data")))
