"""The port CLI's `testnet` (tendermint_tpu_torch/cli.py `cmd_testnet`)
against the JAX CLI's, tolerance exact.

With the same chain id, genesis time and key draws (the JAX command draws
`Ed25519PrivKey.generate()`, patched here to a seeded sequence; the port
takes the same sequence as `draw_key`), `testnet --validators 4`, with and
without `--fast`, and a 20-node tree (the chordal peer topology) write
byte-identical config.toml, genesis.json, node keys and priv_validator
files per home, `--chaos --chaos-seed 7 --twin 0` included.  `--twin` or
`--chaos-seed` without `--chaos` exit 2 with the JAX line and write
nothing; the parsers take the same flags.
"""

import os
import time

import pytest

import tendermint_tpu.cli as jcli
import tendermint_tpu.crypto.keys as jkeys
from tendermint_tpu_torch import cli as pcli
from tendermint_tpu_torch.crypto import keys as pkeys

FILES = ("config/config.toml", "config/genesis.json", "config/node_key.json",
         "config/priv_validator_key.json", "data/priv_validator_state.json")


def _draws(mod):
    seq = iter(range(1 << 20))
    return lambda: mod.Ed25519PrivKey.from_secret(b"testnet-%d" % next(seq))


@pytest.mark.parametrize("extra", [[], ["--fast"], ["--validators", "20", "--base-port", "30000"],
                                   ["--db-backend", "sqlite"],
                                   ["--fast", "--db-backend", "sqlite", "--chaos",
                                    "--chaos-seed", "7", "--twin", "0"]],
                         ids=["default", "fast", "chordal-20", "sqlite", "chaos"])
def test_testnet_tree_equals_jax(extra, tmp_path, monkeypatch):
    monkeypatch.setattr(time, "time_ns", lambda: 1_700_000_000_123_456_789)
    monkeypatch.setattr(jkeys.Ed25519PrivKey, "generate", staticmethod(_draws(jkeys)))
    argv = ["testnet", "--validators", "4", "--chain-id", "tn-chain", *extra]
    j = jcli.build_parser().parse_args(argv + ["--output", str(tmp_path / "j")])
    assert j.fn(j) == 0
    p = pcli.build_parser().parse_args(argv + ["--output", str(tmp_path / "p")])
    assert pcli.cmd_testnet(p, draw_key=_draws(pkeys)) == 0
    homes = sorted(os.listdir(tmp_path / "j"))
    assert homes == sorted(os.listdir(tmp_path / "p")) and len(homes) == p.validators
    for home in homes:
        for f in FILES:
            with open(tmp_path / "j" / home / f, "rb") as a, open(tmp_path / "p" / home / f,
                                                                   "rb") as b:
                assert a.read() == b.read(), (home, f)


def test_testnet_prints_the_jax_line_and_keeps_existing_keys(tmp_path, capsys):
    argv = ["testnet", "--validators", "2", "--chain-id", "c", "--output", str(tmp_path)]
    assert pcli.main(argv) == 0
    first = capsys.readouterr().out
    assert first == f"Successfully initialized 2 node directories in {tmp_path} (chain_id=c)\n"
    key = (tmp_path / "node0" / "config" / "priv_validator_key.json").read_bytes()
    assert pcli.main(argv) == 0  # a second run loads the keys it finds
    assert (tmp_path / "node0" / "config" / "priv_validator_key.json").read_bytes() == key


@pytest.mark.parametrize("flags", [["--chaos"], ["--twin", "1"], ["--chaos-seed", "5"]])
def test_chaos_flags_exit_2_naming_the_roadmap_item(flags, tmp_path, capsys):
    """The chaos flags as the JAX command takes them: `--chaos` alone
    writes the tree (exit 0); `--twin` or `--chaos-seed` without it exit 2
    with the JAX line, before anything is written."""
    rcs, errs = [], []
    for name, mod in (("j", jcli), ("p", pcli)):
        rcs.append(mod.main(["testnet", "--validators", "2", "--output", str(tmp_path / name),
                             *flags]))
        errs.append(capsys.readouterr().err)
    assert rcs[0] == rcs[1] == (0 if flags == ["--chaos"] else 2)
    assert errs[0] == errs[1]
    if rcs[1] == 2:
        assert errs[1] == "--twin / --chaos-seed require --chaos\n"
        assert not os.path.exists(tmp_path / "p")


def test_twin_index_out_of_range_exits_2_as_jax(tmp_path, capsys):
    for mod in (jcli, pcli):
        argv = ["testnet", "--validators", "4", "--output", str(tmp_path / "t"), "--chaos",
                "--twin", "4"]
        assert mod.main(argv) == 2
        assert capsys.readouterr().err == "--twin 4 out of range for 4 validators\n"
    assert not os.path.exists(tmp_path / "t")


def test_testnet_parses_the_jax_flags():
    argv = ["testnet", "-v", "7", "-o", "/x", "--chain-id", "c", "--base-port", "1000",
            "--populate-docker-addresses", "--fast", "--db-backend", "memdb", "--chaos",
            "--chaos-seed", "3", "--twin", "2", "--key-type", "ed25519"]
    p = vars(pcli.build_parser().parse_args(argv))
    j = vars(jcli.build_parser().parse_args(argv))
    assert p.pop("fn").__name__ == j.pop("fn").__name__ == "cmd_testnet"
    assert p == j
