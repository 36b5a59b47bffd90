"""The port's fleet telescope (tendermint_tpu_torch/tools/telescope.py)
against the JAX package's, tolerance exact: fed the same polls and the
same clock (`now_fn` in the port; the JAX module's `time` replaced for
the test), `snapshot()` returns equal dicts and `render()` equal text.

- A target nobody listens on flips DOWN after one sweep; the board still
  renders and serializes.
- A SIGKILLed node's buffered window stays on the merged timeline, with a
  measured offset when its wire-hop samples suffice.
- Live: two port nodes (`device="cpu"`, RPC on free ports) polled by the
  port's telescope; one stops, the next sweep marks it DOWN and keeps its
  window; the JAX telescope given the same scopes gives the same board.
- `/snapshot` is served on rpc/http.py with the JAX endpoint's status,
  body and Content-Type (`application/json; charset=utf-8`), and its 404
  and 405 answers.
"""

import asyncio
import json
import time
import types

import pytest

from tendermint_tpu.tools import telescope as jtele
from tendermint_tpu_torch.tools import telescope as ptele

NOW = 1_700_000_123.456


def now():
    return NOW


def jax_clock(monkeypatch):
    """The JAX module's clock, fixed at NOW (its snapshot and render read
    time.time and time.strftime)."""
    monkeypatch.setattr(jtele, "time", types.SimpleNamespace(
        time=now, strftime=lambda fmt: time.strftime(fmt, time.localtime(now()))))


def copy_scopes(src, dst):
    for a, b in zip(src.scopes, dst.scopes):
        for slot in ptele._NodeScope.__slots__:
            value = getattr(a, slot)
            setattr(b, slot, list(value) if isinstance(value, list) else value)


def equal_boards(port, jax_, monkeypatch):
    jax_clock(monkeypatch)
    copy_scopes(port, jax_)
    snaps = port.snapshot(), jax_.snapshot()
    assert snaps[0] == snaps[1]
    assert port.render(snaps[0]) == jax_.render(snaps[1])
    return snaps[0]


def hop(lat_ms, t_ns):
    return {"kind": "gossip.hop", "frame": "vote_batch", "hop": 0, "lat_ms": lat_ms,
            "t_ns": t_ns}


def test_dead_target_flips_down_but_the_board_survives(monkeypatch):
    tele = ptele.Telescope(["127.0.0.1:1"], interval=0.01, now_fn=now)
    asyncio.run(tele.poll_once())
    assert tele.scopes[0].alive is False and tele.scopes[0].failures == 1
    snap = equal_boards(tele, jtele.Telescope(["127.0.0.1:1"], interval=0.01), monkeypatch)
    assert snap["fleet"]["alive"] == 0 and snap["fleet"]["total"] == 1
    assert snap["t_unix"] == round(NOW, 3)
    json.dumps(snap)
    assert "DOWN" in tele.render(snap)


def test_killed_node_keeps_its_window_on_the_merged_timeline(monkeypatch):
    ms = 1_000_000
    commits = [{"kind": "commit", "height": h, "block": "ef" * 4, "t_ns": h * 100 * ms}
               for h in (3, 4, 5)]
    boards = {}
    for name, mod in (("port", ptele), ("jax", jtele)):
        kw = {"now_fn": now} if mod is ptele else {}
        tele = mod.Telescope(["a:26657", "b:26657", "c:26657"], interval=0.01, **kw)
        for scope, lat in zip(tele.scopes, (10.0, 30.0, 20.0)):
            scope.name = scope.target[0]
            scope.anchor = {"mono_ns": 0, "wall_ns": 10**12}
            scope.events = commits + [hop(lat, i) for i in range(9)]
            scope.height = 5
        tele.scopes[0].alive = True
        tele.scopes[1].alive = False  # SIGKILLed mid-run
        tele.scopes[1].last_err = "ConnectionRefusedError(111, 'Connect call failed')"
        tele.scopes[2].alive = True
        tele.scopes[2].height = 4
        boards[name] = tele
    snap = equal_boards(boards["port"], boards["jax"], monkeypatch)
    assert snap["fleet"]["alive"] == 2 and snap["fleet"]["tip_spread"] == 1
    assert snap["merged"]["offset_sources"] == ["measured"] * 3
    dead = snap["nodes"][1]
    assert dead["alive"] is False and dead["events_buffered"] > 0 and dead["net_budget"]["hops"]
    text = boards["port"].render(snap)
    assert "DOWN" in text and "measured" in text and "last error" in text


def test_window_bounds_the_buffer():
    tele = ptele.Telescope(["a:26657"], window=10)
    s = tele.scopes[0]
    s.events = [{"kind": "x", "t_ns": i} for i in range(25)]
    if len(s.events) > tele.window:
        del s.events[: len(s.events) - tele.window]
    assert len(s.events) == 10 and s.events[0]["t_ns"] == 15


def test_stalled_part_stream_raises_an_alert(monkeypatch):
    boards = {}
    for name, mod in (("port", ptele), ("jax", jtele)):
        kw = {"now_fn": now} if mod is ptele else {}
        tele = mod.Telescope(["a:1"], stall_ms=100.0, **kw)
        s = tele.scopes[0]
        s.name, s.alive, s.height = "a", True, 7
        s.anchor = {"mono_ns": 0, "wall_ns": 10**12}
        s.events = [{"kind": "proposal", "height": 8, "t_ns": 0},
                    {"kind": "loop.lag", "lag_ms": 1.0, "t_ns": 500 * 10**6}]
        boards[name] = tele
    snap = equal_boards(boards["port"], boards["jax"], monkeypatch)
    assert snap["fleet"]["stalled_parts"] == {"a": [8]}
    assert "ALERT a: part stream stalled at heights [8]" in boards["port"].render(snap)


async def test_live_nodes_then_one_killed(tmp_path, monkeypatch):
    """Two port nodes polled live; node 1 stops between sweeps: it stays
    on the board DOWN with its window, node 0 stays UP, and the JAX
    telescope given the same scopes gives the same board."""
    import test_torch_net as tnet
    import test_torch_tracemerge as tm

    nodes = tm.port_net_nodes(tmp_path, n=2, name="live", rpc=True)
    try:
        for n in nodes:
            await n.start()
        await tnet._mesh(nodes)
        await tnet._wait_height(nodes, 3, 60.0)
        targets = [n.rpc_server.listen_addr for n in nodes]
        tele = ptele.Telescope(targets, interval=0.01, now_fn=now)
        await tele.poll_once()
        first = tele.snapshot()
        assert [(n["name"], n["alive"]) for n in first["nodes"]] == [("live0", True),
                                                                     ("live1", True)]
        await nodes[1].stop()
        await tele.poll_once()
    finally:
        await tnet._stop(nodes)
    snap = equal_boards(tele, jtele.Telescope(targets, interval=0.01), monkeypatch)
    up, down = snap["nodes"]
    assert up["alive"] is True and down["alive"] is False and "last_err" in down
    assert down["name"] == "live1" and down["events_buffered"] > 0 and down["failures"] == 1
    assert snap["fleet"]["alive"] == 1 and snap["merged"]["nodes"] == ["live0", "live1"]
    assert tele.scopes[0].since > 0 and tele.scopes[0].last_ok_t == NOW


async def request(addr, head: bytes):
    from tendermint_tpu_torch.rpc import http as phttp

    host, port = addr.rsplit(":", 1)
    reader, writer = await asyncio.open_connection(host, int(port))
    try:
        writer.write(head)
        await writer.drain()
        return await phttp.read_response(reader)
    finally:
        writer.close()


def get(path, method="GET"):
    return f"{method} {path} HTTP/1.1\r\nHost: x\r\nConnection: close\r\n\r\n".encode()


async def test_snapshot_endpoint_answers_equal_jax():
    board = {"t_unix": NOW, "nodes": [{"name": "a", "alive": True}], "fleet": {"alive": 1},
             "merged": {"offsets_ms": [0.5]}}
    teles = {"port": ptele.Telescope(["a:1"], serve_addr="127.0.0.1:0", now_fn=now),
             "jax": jtele.Telescope(["a:1"], serve_addr="127.0.0.1:0")}
    answers = {}
    try:
        for name, tele in teles.items():
            tele.last_snapshot = board
            await tele.start_server()
            assert not tele.bound_addr.endswith(":0")
            answers[name] = [await request(tele.bound_addr, h) for h in (
                get("/snapshot"), get("/"), get("/snapshot", "POST"))]
    finally:
        for tele in teles.values():
            await tele.stop_server()
    for name, got in answers.items():
        (status, headers, body), (s404, _, b404), (s405, _, b405) = got
        assert status == 200 and json.loads(body) == board, name
        assert headers["content-type"] == "application/json; charset=utf-8", name
        assert (s404, b404, s405, b405) == (404, b"404: Not Found", 405,
                                            b"405: Method Not Allowed"), name
    assert answers["port"][0][2] == answers["jax"][0][2]


async def test_snapshot_endpoint_refuses_a_taken_address():
    holder = ptele.Telescope(["a:1"], serve_addr="127.0.0.1:0")
    await holder.start_server()
    try:
        taken = ptele.Telescope(["a:1"], serve_addr=holder.bound_addr)
        with pytest.raises(OSError, match=f"telescope failed to bind {holder.bound_addr!r}: "):
            await taken.start_server()
    finally:
        await holder.stop_server()
    await holder.stop_server()


def test_run_prints_one_json_line_per_sweep(capsys):
    tele = ptele.Telescope(["127.0.0.1:1"], interval=0.01, now_fn=now)
    last = asyncio.run(tele.run(cycles=2, json_lines=True))
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 2 and json.loads(lines[-1]) == json.loads(json.dumps(last))
    assert tele.scopes[0].polls == 2 and tele.scopes[0].failures == 2
