"""The port's Config (tendermint_tpu_torch/config.py) against the JAX
package's: every section's defaults, the TOML bytes of save_config, each
package loading the other's file, test_config, and one case per
validate_basic rule with the same ValueError message.  Tolerance: exact
(dataclasses.asdict equality, byte equality of the files).
"""

import dataclasses

import pytest

from tendermint_tpu import config as jconfig
from tendermint_tpu_torch import config as pconfig

SECTIONS = ["base", "rpc", "p2p", "mempool", "fast_sync", "statesync", "consensus", "tpu",
            "chaos", "storage", "tx_index", "instrumentation", "liteserve"]


def _set(cfg, path, value):
    obj = cfg
    *parents, leaf = path.split(".")
    for p in parents:
        obj = getattr(obj, p)
    setattr(obj, leaf, value)


@pytest.mark.parametrize("section", SECTIONS)
def test_section_defaults_equal_jax(section):
    p, j = getattr(pconfig.Config(), section), getattr(jconfig.Config(), section)
    assert type(p).__name__ == type(j).__name__
    assert dataclasses.asdict(p) == dataclasses.asdict(j)
    assert [f.name for f in dataclasses.fields(p)] == [f.name for f in dataclasses.fields(j)]


def test_config_helpers_equal_jax(tmp_path):
    home = str(tmp_path / "h")
    p, j = pconfig.default_config(home), jconfig.default_config(home)
    for helper in ("genesis_file", "priv_validator_key_file", "priv_validator_state_file",
                   "node_key_file", "wal_file", "addr_book_file", "mempool_wal_dir",
                   "flight_spool_file", "db_dir"):
        assert getattr(p, helper)() == getattr(j, helper)(), helper
    assert p.mempool.as_dict() == j.mempool.as_dict()
    assert pconfig.default_config().home == jconfig.default_config().home
    p.ensure_dirs()
    assert sorted(x.name for x in (tmp_path / "h").iterdir()) == ["config", "data"]


def test_test_config_equals_jax(tmp_path):
    assert (dataclasses.asdict(pconfig.test_config(str(tmp_path)))
            == dataclasses.asdict(jconfig.test_config(str(tmp_path))))


def _custom(mod, home):
    cfg = mod.Config(home=home)
    cfg.base.chain_id = "toml-parity"
    cfg.base.moniker = "n1"
    cfg.p2p.laddr = "none"
    cfg.rpc.laddr = ""
    cfg.rpc.cors_allowed_origins = ["https://a.example", "*"]
    cfg.mempool.sig_precheck = True
    cfg.mempool.wal_dir = "data/mempool.wal"
    cfg.consensus.timeout_commit = 0.25
    cfg.tpu.tabulated = "on"
    cfg.tpu.flush_interval = 1e-05
    cfg.statesync.trust_period = 3600.5
    cfg.instrumentation.watchdog_lag_ms = 250.0
    return cfg


@pytest.mark.parametrize("which", ["default", "test_config", "custom"])
def test_save_config_bytes_and_cross_load(which, tmp_path):
    home = str(tmp_path)
    make = {"default": lambda m: m.default_config(home),
            "test_config": lambda m: m.test_config(home),
            "custom": lambda m: _custom(m, home)}[which]
    pp, jp = str(tmp_path / "port.toml"), str(tmp_path / "jax.toml")
    pconfig.save_config(make(pconfig), pp)
    jconfig.save_config(make(jconfig), jp)
    with open(pp, "rb") as f:
        port_bytes = f.read()
    with open(jp, "rb") as f:
        jax_bytes = f.read()
    assert port_bytes == jax_bytes
    assert port_bytes.startswith(b"# tendermint_tpu config\n")
    want = dataclasses.asdict(make(jconfig))
    # each package loads the other's file to the same Config
    assert dataclasses.asdict(pconfig.load_config(jp, home=home)) == want
    assert dataclasses.asdict(jconfig.load_config(pp, home=home)) == want
    assert (dataclasses.asdict(pconfig.load_config(pp))
            == dataclasses.asdict(jconfig.load_config(jp)))


RULES = {
    "db_backend": [("base.db_backend", "leveldb")],
    "key_type": [("base.key_type", "rsa")],
    "timeout_propose": [("consensus.timeout_propose", -1.0)],
    "timeout_prevote": [("consensus.timeout_prevote", -1.0)],
    "timeout_precommit": [("consensus.timeout_precommit", -1.0)],
    "timeout_commit": [("consensus.timeout_commit", -0.5)],
    "commit_grace": [("consensus.commit_grace", -0.1)],
    "mempool_size": [("mempool.size", -1)],
    "mempool_wal_size_limit": [("mempool.wal_size_limit", 100)],
    "mempool_broadcast_rate_bytes": [("mempool.broadcast_rate_bytes", -1)],
    "mempool_broadcast_batch_bytes": [("mempool.broadcast_batch_bytes", 100)],
    "rpc_max_open_connections": [("rpc.max_open_connections", -1)],
    "rpc_broadcast_rate": [("rpc.broadcast_rate", -1.0)],
    "rpc_broadcast_rate_burst": [("rpc.broadcast_rate_burst", 0)],
    "rpc_max_broadcast_inflight": [("rpc.max_broadcast_inflight", -1)],
    "rpc_max_commit_waiters": [("rpc.max_commit_waiters", -1)],
    "rpc_max_batch_request_items": [("rpc.max_batch_request_items", 0)],
    "fastsync_version": [("fast_sync.version", "v9")],
    "flight_recorder_size": [("instrumentation.flight_recorder_size", 0)],
    "trace_sample_high_rate": [("instrumentation.trace_sample_high_rate", 0)],
    "loop_probe_interval": [("instrumentation.loop_probe_interval", 0.0)],
    "flight_spool_flush_interval": [("instrumentation.flight_spool_flush_interval", 0.0)],
    "flight_spool_size_limit": [("instrumentation.flight_spool_size_limit", 100)],
    "watchdog_interval": [("instrumentation.watchdog_interval", 0.0)],
    "watchdog_stall_seconds": [("instrumentation.watchdog_stall_seconds", 0.0)],
    "watchdog_round_churn": [("instrumentation.watchdog_round_churn", 0)],
    "watchdog_mempool_ratio": [("instrumentation.watchdog_mempool_ratio", 1.5)],
    "watchdog_shed_rate": [("instrumentation.watchdog_shed_rate", -1.0)],
    "watchdog_clock_drift_seconds": [("instrumentation.watchdog_clock_drift_seconds", 0.0)],
    "watchdog_autodump_min_interval": [("instrumentation.watchdog_autodump_min_interval", -1.0)],
    "gossip_part_burst": [("consensus.gossip_part_burst", 0)],
    "gossip_vote_batch_bytes": [("consensus.gossip_vote_batch_bytes", 100)],
    "gossip_relay_degree": [("consensus.gossip_relay_degree", -1)],
    "gossip_relay_min_peers": [("consensus.gossip_relay_min_peers", -1)],
    "gossip_relay_debounce": [("consensus.gossip_relay_debounce", -0.01)],
    "statesync_rpc_servers": [("statesync.enable", True)],
    "statesync_trust_height": [("statesync.enable", True),
                               ("statesync.rpc_servers", "tcp://a:1,tcp://b:1")],
    "statesync_trust_hash": [("statesync.enable", True),
                             ("statesync.rpc_servers", "tcp://a:1"),
                             ("statesync.trust_height", 1), ("statesync.trust_hash", "zz")],
    "statesync_snapshot_interval": [("statesync.snapshot_interval", -1)],
    "statesync_snapshot_chunk_bytes": [("statesync.snapshot_chunk_bytes", 0)],
    "statesync_snapshot_keep_recent": [("statesync.snapshot_keep_recent", 0)],
    "statesync_chunk_fetch_retries": [("statesync.chunk_fetch_retries", -1)],
    "chaos_twin": [("chaos.twin", True)],
    "chaos_clock_skew": [("chaos.clock_skew", 1.5)],
    "tpu_mesh": [("tpu.mesh", "everywhere")],
    "tpu_mesh_devices": [("tpu.mesh_devices", -1)],
    "tpu_chunk_size": [("tpu.chunk_size", -1)],
    "tpu_chunk_depth": [("tpu.chunk_depth", 0)],
    "tpu_tabulated": [("tpu.tabulated", "maybe")],
    "storage_integrity_scan_limit": [("storage.integrity_scan_limit", -1)],
    "storage_min_free_bytes": [("storage.min_free_bytes", -1)],
    "watchdog_disk_fault_hold": [("instrumentation.watchdog_disk_fault_hold", -1.0)],
}


@pytest.mark.parametrize("rule", sorted(RULES))
def test_validate_basic_rule_message_equals_jax(rule, tmp_path):
    messages = []
    for mod in (pconfig, jconfig):
        cfg = mod.Config(home=str(tmp_path))
        cfg.validate_basic()  # the defaults pass
        for path, value in RULES[rule]:
            _set(cfg, path, value)
        with pytest.raises(ValueError) as err:
            cfg.validate_basic()
        messages.append(str(err.value))
    assert messages[0] == messages[1]
    assert messages[0]
