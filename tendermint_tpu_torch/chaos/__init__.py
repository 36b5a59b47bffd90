"""Chaos engine: deterministic fault injection + BFT invariant checking
(the port's copy of tendermint_tpu/chaos/).

Every fault is SEEDED and REPLAYABLE, every run is judged by the same
invariant checker, and both the in-process net and the multi-process
localnet rig are driven by the same scenario schedule.

Pieces:

  link.py      per-link LinkPolicy (directional drop/delay/throttle between
               named peers) + LinkPolicyTable, the runtime-controllable
               upgrade of p2p/fuzz.py — partitions can form and HEAL mid-run
  clock.py     pluggable consensus time source + per-node skew injection
  twin.py      TwinSigner: a privval that bypasses the last-sign-state
               guard and equivocates, driving the full accountability
               pipeline (VoteSet conflict -> EvidencePool -> block ->
               BeginBlock byzantine_validators)
  scenario.py  declarative seeded fault timelines + the async runner and
               the in-process rig (its `valset` clauses run through the
               staking app)
  checker.py   Jepsen-flavor invariant checker: agreement, no height
               regression, bounded recovery, accountability, no serving
               of corrupted blocks
  disk.py      the disk as a fault domain: per-store seeded ENOSPC / EIO /
               torn appends / lying fsyncs / read bit-rot (FaultyDB,
               FaultyGroup, DiskFaultTable) + persistent block-store rot

Faults are injected only when `[chaos] enabled` is on (config) or a test
holds direct handles; the unsafe RPC control routes additionally require
`rpc.unsafe`.
"""

from .checker import InvariantChecker, RecoveryTimer
from .clock import Clock, SkewedClock, SYSTEM_CLOCK
from .disk import (
    DiskFaultTable,
    DiskPolicy,
    FaultyDB,
    FaultyGroup,
    policy_for,
    rot_block_store,
)
from .link import LinkPolicy, LinkPolicyTable
from .scenario import FaultEvent, InProcRig, Scenario, ScenarioRunner
from .twin import TwinSigner, install_twin

__all__ = [
    "Clock",
    "DiskFaultTable",
    "DiskPolicy",
    "FaultEvent",
    "FaultyDB",
    "FaultyGroup",
    "InProcRig",
    "InvariantChecker",
    "LinkPolicy",
    "LinkPolicyTable",
    "RecoveryTimer",
    "Scenario",
    "ScenarioRunner",
    "SkewedClock",
    "SYSTEM_CLOCK",
    "TwinSigner",
    "install_twin",
    "policy_for",
    "rot_block_store",
]
