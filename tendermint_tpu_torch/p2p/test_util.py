"""In-process p2p test helpers (the port's copy of
tendermint_tpu/p2p/test_util.py).

Reference parity: p2p/test_util.go (MakeConnectedSwitches:77,
Connect2Switches) — real switches wired over localhost TCP, so multi-node
consensus tests run without any cluster.
"""

from __future__ import annotations

import asyncio
from typing import Callable, List

from .key import NodeKey
from .node_info import NodeInfo
from .switch import Switch
from .transport import Transport


def make_switch(network: str = "test-net", moniker: str = "test") -> Switch:
    nk = NodeKey.generate()
    ni = NodeInfo(node_id=nk.id, network=network, moniker=moniker)
    return Switch(Transport(nk, ni))


async def start_switch(sw: Switch) -> str:
    addr = await sw.transport.listen("127.0.0.1:0")
    await sw.start()
    return addr


async def connect_switches(sw1: Switch, sw2: Switch) -> None:
    """Dial sw2 from sw1 and wait until both see each other."""
    addr = f"{sw2.node_id}@{sw2.transport.listen_addr}"
    await sw1.dial_peer(addr)
    for _ in range(200):
        if sw2.node_id in sw1.peers and sw1.node_id in sw2.peers:
            return
        await asyncio.sleep(0.01)
    raise TimeoutError("switches failed to connect")


async def make_connected_switches(
    n: int, init: Callable[[int, Switch], None] = None, network: str = "test-net"
) -> List[Switch]:
    """N switches in a full mesh (MakeConnectedSwitches)."""
    switches = [make_switch(network, moniker=f"node{i}") for i in range(n)]
    for i, sw in enumerate(switches):
        if init is not None:
            init(i, sw)
        await start_switch(sw)
    for i in range(n):
        for j in range(i + 1, n):
            await connect_switches(switches[i], switches[j])
    return switches


async def stop_switches(switches: List[Switch]) -> None:
    for sw in switches:
        if sw.is_running:
            await sw.stop()
