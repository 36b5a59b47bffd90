"""The port's write-ahead logs (tendermint_tpu_torch: libs/autofile.py,
consensus/wal.py, the mempool's tx journal) against the JAX package's.

The same records written through either package give the same files, byte
for byte; either package reads, repairs and resyncs the other's files the
same way.  WAL records carry `time_ns` from the wall clock, so the
byte-equality cases pass it explicitly.  Tolerance: exact everywhere.
"""

import os
import types

import numpy as np
import pytest

import tendermint_tpu.consensus.wal as jwal
import tendermint_tpu.libs.autofile as jautofile
import tendermint_tpu.mempool as jmempool
import tendermint_tpu.proxy as jproxy
import tendermint_tpu.types as jtypes
from tendermint_tpu.crypto.keys import Ed25519PrivKey as JPrivKey
from tendermint_tpu_torch import mempool as pmempool
from tendermint_tpu_torch import proxy as pproxy
from tendermint_tpu_torch.consensus import wal as pwal
from tendermint_tpu_torch.crypto.keys import Ed25519PrivKey
from tendermint_tpu_torch.libs import autofile as pautofile
from tendermint_tpu_torch.types import block as pblock
from tendermint_tpu_torch.types import vote as pvote

PORT = types.SimpleNamespace(name="port", autofile=pautofile, wal=pwal, mempool=pmempool,
                             proxy=pproxy, PrivKey=Ed25519PrivKey, Vote=pvote.Vote,
                             BlockID=pblock.BlockID, PartSetHeader=pblock.PartSetHeader)
JAX = types.SimpleNamespace(name="jax", autofile=jautofile, wal=jwal, mempool=jmempool,
                            proxy=jproxy, PrivKey=JPrivKey, Vote=jtypes.Vote,
                            BlockID=jtypes.BlockID, PartSetHeader=jtypes.PartSetHeader)
BOTH = (PORT, JAX)
SEC = 1_000_000_000
T0 = 1_700_000_000 * SEC


def files(d):
    """Every file under d: {name: bytes}."""
    return {n: open(os.path.join(d, n), "rb").read() for n in sorted(os.listdir(d))}


def payloads(seed, n, lo=1, hi=300):
    rng = np.random.default_rng(seed)
    return [rng.bytes(int(rng.integers(lo, hi))) for _ in range(n)]


def records(ns):
    """Consensus WAL records of every kind, with a signed vote and a block
    part inside, time_ns given."""
    key = ns.PrivKey.from_secret(b"wal-key")
    bid = ns.BlockID(b"\x07" * 32, ns.PartSetHeader(2, b"\x08" * 32))
    vote = ns.Vote(2, 5, 1, bid, T0 + 3, key.pub_key().address(), 0)
    vote.signature = key.sign(vote.sign_bytes("wal-chain"))
    return [
        {"type": "timeout", "height": 5, "round": 0, "step": 1, "duration": 1.0, "time_ns": T0},
        {"type": "roundstate", "height": 5, "round": 0, "step": "NewRound", "time_ns": T0 + 1},
        {"type": "msg", "peer_id": "", "msg": {"type": "vote", "vote": vote.to_dict()},
         "time_ns": T0 + 2},
        {"type": "msg", "peer_id": "peer-a", "msg": {"type": "block_part", "height": 5,
                                                      "round": 1, "part": {"index": 0,
                                                                           "bytes": b"x" * 70,
                                                                           "proof": None}},
         "time_ns": T0 + 3},
        {"type": "endheight", "height": 5, "time_ns": T0 + 4},
    ]


# ---------------------------------------------------------------------------
# libs/autofile
# ---------------------------------------------------------------------------


def _group_trace(ns, d, head_limit, group_limit, data):
    g = ns.autofile.Group(os.path.join(d, "log"), head_size_limit=head_limit,
                          group_size_limit=group_limit)
    sizes = []
    for p in data:
        g.append_record(p)
        g.flush()
        g.maybe_rotate()
        sizes.append((g.head_size(), g.chunk_indices()))
    out = {"sizes": sizes, "read_all": g.read_all(), "records": g.read_records(),
           "stats": ns.autofile.group_disk_stats(g.head_path), "usage": ns.autofile.dir_usage(d)}
    g.close()
    out["files"] = files(d)
    return out


@pytest.mark.parametrize("head_limit,group_limit", [(512, 0), (700, 2048), (1 << 20, 0)])
def test_group_rotation_and_limits_match_jax(tmp_path, head_limit, group_limit):
    data = payloads(1, 60)
    ours = _group_trace(PORT, str(tmp_path / "port"), head_limit, group_limit, data)
    theirs = _group_trace(JAX, str(tmp_path / "jax"), head_limit, group_limit, data)
    assert ours == theirs
    if head_limit == 512:
        assert len(ours["files"]) > 5  # rotated
    if group_limit:
        assert sum(map(len, ours["files"].values())) <= group_limit + head_limit
        assert ours["records"][1]["records"] < len(data)  # the oldest chunks went


def test_walk_frames_and_resync_match_jax():
    """Frames with torn tails, flipped bytes and absurd lengths: the same
    terminals, skipped regions and next-frame offsets in both packages."""
    rng = np.random.default_rng(2)
    clean = b"".join(pautofile.encode_frame(p) for p in payloads(3, 30))
    assert clean == b"".join(jautofile.encode_frame(p) for p in payloads(3, 30))
    cases = [clean, clean[:-5], clean[:3], b""]
    for _ in range(25):
        raw = bytearray(clean)
        for pos in rng.integers(0, len(raw), int(rng.integers(1, 4))):
            raw[pos] ^= int(rng.integers(1, 256))
        cases.append(bytes(raw[: int(rng.integers(len(raw) // 2, len(raw) + 1))]))
    for raw in cases:
        for resync in (False, True):
            assert (list(pautofile.walk_frames(raw, resync=resync))
                    == list(jautofile.walk_frames(raw, resync=resync)))
        for start in (0, 1, 17):
            assert pautofile.find_next_frame(raw, start) == jautofile.find_next_frame(raw, start)


def test_fsync_dir_and_stats_of_a_missing_group(tmp_path):
    for ns in BOTH:
        ns.autofile.fsync_dir(str(tmp_path / "nope" / "file"))  # best effort, no raise
        assert ns.autofile.group_disk_stats(str(tmp_path / "absent")) is None
        assert ns.autofile.dir_usage(str(tmp_path / "absent")) == {}


# ---------------------------------------------------------------------------
# consensus/wal.py
# ---------------------------------------------------------------------------


def test_wal_records_and_files_byte_equal(tmp_path):
    recs = records(PORT)
    assert [pwal.encode_record(dict(r)) for r in recs] == [
        jwal.encode_record(dict(r)) for r in records(JAX)]
    out = {}
    for ns in BOTH:
        w = ns.wal.WAL(str(tmp_path / ns.name / "wal"))
        for i, r in enumerate(records(ns)):
            (w.write_sync if i % 2 else w.write)(dict(r))
        w.flush_and_sync()
        out[ns.name] = (files(str(tmp_path / ns.name)), w.all_records(), w.replay_records())
        w.close()
    assert out["port"] == out["jax"]
    # each package reads the other's file
    assert (pwal.WAL(str(tmp_path / "jax" / "wal")).all_records()
            == jwal.WAL(str(tmp_path / "port" / "wal")).all_records() == out["port"][1])


def test_torn_tail_is_truncated_at_open(tmp_path):
    raw = b"".join(jwal.encode_record(dict(r)) for r in records(JAX))
    for ns in BOTH:
        for cut in (3, 9, 40):
            d = tmp_path / f"{ns.name}-{cut}"
            d.mkdir()
            (d / "wal").write_bytes(raw + raw[:cut])
            w = ns.wal.WAL(str(d / "wal"))
            assert w.group.head_size() == len(raw)
            w.write({"type": "endheight", "height": 6, "time_ns": T0 + 9})
            assert [r["type"] for r in w.all_records()][-2:] == ["endheight", "endheight"]
            w.close()
            assert (d / "wal").read_bytes() == raw + jwal.encode_record(
                {"type": "endheight", "height": 6, "time_ns": T0 + 9})


def test_crc_flip_strict_raises_replay_skips(tmp_path):
    raw = bytearray(b"".join(jwal.encode_record(dict(r)) for r in records(JAX)))
    second = len(jwal.encode_record(dict(records(JAX)[0])))
    raw[second + 12] ^= 0x40  # inside the second record's payload
    out = {}
    for ns in BOTH:
        d = tmp_path / ns.name
        d.mkdir()
        (d / "wal").write_bytes(bytes(raw))
        w = ns.wal.WAL(str(d / "wal"))
        assert w.group.head_size() == len(raw)  # corruption is not a torn tail
        with pytest.raises(ns.wal.WALCorruptionError) as err:
            w.all_records()
        recs = w.replay_records()
        found = w.search_for_end_height(5)
        out[ns.name] = (str(err.value), recs, w.corrupt_regions_skipped, w.corrupt_bytes_skipped,
                        found, ns.wal.decode_records_resync(bytes(raw)))
        w.close()
    assert out["port"] == out["jax"]
    # the flipped record is lost, nothing is fabricated, the endheight survives
    assert out["port"][2] >= 1 and 0 < len(out["port"][1]) < len(records(PORT))
    assert out["port"][4][1] is True


def test_search_for_end_height_matches_jax(tmp_path):
    out = {}
    for ns in BOTH:
        w = ns.wal.WAL(str(tmp_path / ns.name / "wal"), head_size_limit=200)
        for h in range(1, 5):
            w.write_sync({"type": "msg", "peer_id": "", "msg": {"type": "x", "h": h},
                          "time_ns": T0 + h})
            w.write_end_height(h)
        w.write({"type": "msg", "peer_id": "p", "msg": {"type": "y"}, "time_ns": T0})
        found = {}
        for h in (0, 1, 3, 4, 9):
            recs, ok = w.search_for_end_height(h)
            found[h] = (ok, None if recs is None else [
                {k: v for k, v in r.items() if k != "time_ns"} for r in recs])
        out[ns.name] = (found, sorted(os.listdir(tmp_path / ns.name)))
        w.close()
    assert out["port"] == out["jax"]
    assert len(out["port"][1]) > 2  # the head rotated
    nil = pwal.NilWAL()
    assert (nil.all_records(), nil.replay_records(), nil.search_for_end_height(1)) == (
        [], [], (None, False))


# ---------------------------------------------------------------------------
# the mempool's tx journal
# ---------------------------------------------------------------------------


async def _journal_trace(ns, d, txs, legacy=b""):
    conns = ns.proxy.AppConns(ns.proxy.default_client_creator("kvstore"))
    await conns.start()
    try:
        mp = ns.mempool.Mempool(conns.mempool(), {"size": 1000})
        if legacy:
            os.makedirs(d, exist_ok=True)
            with open(os.path.join(d, "wal"), "wb") as f:
                f.write(legacy)
        mp.init_wal(d, size_limit=8192)
        for tx in txs:
            try:
                await mp.check_tx(tx)
            except Exception:  # noqa: BLE001 - rejected txs are not journaled
                pass
        replay = mp.wal_txs()
        mp.close_wal()
        mp.close_wal()  # a second close is a no-op
        return replay, files(d), mp.wal_txs()
    finally:
        await conns.stop()


@pytest.mark.parametrize("legacy,n,head", [(b"", 300, []),
                                           (b"6b3d31\n6b3d32\n", 20, [b"k=1", b"k=2"]),
                                           (b"6b3d33\nzz-torn", 20, [b"k=3"])])
async def test_mempool_journal_matches_jax(tmp_path, legacy, n, head):
    """init_wal, every accepted tx journaled (a duplicate is not), rotation
    and the oldest chunks dropped past the size limit, wal_txs; a legacy
    hex-line journal appended to by the framed writer replays first."""
    txs = [b"k%d=%s" % (i, b"v" * (i % 90)) for i in range(n)] + [b"k3=" + b"v" * 3]
    ours = await _journal_trace(PORT, str(tmp_path / "port"), txs, legacy)
    theirs = await _journal_trace(JAX, str(tmp_path / "jax"), txs, legacy)
    assert ours == theirs
    replay, written, closed = ours
    assert closed == [] and replay[-1] == txs[-2]
    if legacy:
        assert replay == head + txs[:-1]
    else:
        assert len(written) > 1 and 0 < len(replay) < n  # rotated, the oldest dropped
        assert replay == txs[n - len(replay):-1]


async def test_pure_legacy_journal_replays_as_jax(tmp_path):
    for ns in BOTH:
        d = tmp_path / ns.name
        d.mkdir()
        (d / "wal").write_bytes(b"6b3d31\n6b3d32\n6b3")
        conns = ns.proxy.AppConns(ns.proxy.default_client_creator("kvstore"))
        await conns.start()
        try:
            mp = ns.mempool.Mempool(conns.mempool())
            assert mp.wal_txs() == []  # no journal yet
            mp.init_wal(str(d))
            assert mp.wal_txs() == [b"k=1", b"k=2"]
            mp.close_wal()
        finally:
            await conns.stop()


def test_journal_write_fault_reaches_storage_health():
    """A failing journal write is logged and handed to StorageHealth; the
    tx path keeps going (best effort, as in the JAX package)."""
    notes = {}
    for ns in BOTH:
        mp = ns.mempool.Mempool(None)

        class Broken:
            def append_record(self, data):
                raise OSError(28, "No space left on device")

        class Health:
            def __init__(self):
                self.seen = []

            def note_write_error(self, what, err):
                self.seen.append((what, err.errno))

        mp._wal, mp.storage_health = Broken(), Health()
        mp._wal_write(b"tx")
        notes[ns.name] = mp.storage_health.seen
    assert notes["port"] == notes["jax"] == [("mempool-wal", 28)]


def test_walk_is_deterministic_on_random_buffers():
    """Random bytes resync identically (the chain prefilter and crc budget)."""
    rng = np.random.default_rng(5)
    for _ in range(10):
        raw = rng.bytes(int(rng.integers(50, 3000)))
        assert (list(pautofile.walk_frames(raw, resync=True))
                == list(jautofile.walk_frames(raw, resync=True)))

