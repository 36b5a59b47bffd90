"""tm-signer-harness: acceptance tests for remote signer implementations
(the port's copy of tendermint_tpu/tools/signer_harness.py: the same
checks, lines and exit codes).

Reference parity: tools/tm-signer-harness/internal/test_harness.go — the
harness plays the NODE side of the privval socket (listens; the signer
under test dials in) and runs the acceptance checks a validator operator
needs before trusting a signer in production:

  1. PubKey       — the signer serves a pubkey (and it matches
                    --expected-pubkey when given)
  2. SignProposal — a proposal signature verifies under that pubkey
  3. SignVote     — prevote + precommit signatures verify
  4. DoubleSign   — a conflicting same-HRS vote is REFUSED

Usage (against the bundled signer server):
    python -m tendermint_tpu_torch.tools.signer_harness --laddr tcp://127.0.0.1:31559

Exit code 0 iff every check passes.
"""

from __future__ import annotations

import argparse
import asyncio
import sys
import time

from ..privval.signer import RemoteSignerError, SignerClient
from ..types.block import BlockID, PartSetHeader
from ..types.canonical import PRECOMMIT_TYPE, PREVOTE_TYPE
from ..types.proposal import Proposal
from ..types.vote import Vote

CHAIN_ID = "signer-harness-chain"


class HarnessFailure(Exception):
    def __init__(self, check: str, detail: str):
        super().__init__(f"{check}: {detail}")
        self.check = check


def _vote(addr: bytes, h: int, t: int, blk: bytes) -> Vote:
    return Vote(
        type=t,
        height=h,
        round=0,
        block_id=BlockID(blk, PartSetHeader(1, b"\x02" * 32)),
        timestamp_ns=time.time_ns(),
        validator_address=addr,
        validator_index=0,
    )


async def run_harness(
    laddr: str, accept_timeout: float = 30.0, expected_pubkey_hex: str = ""
) -> list:
    """Returns [(check, ok, detail)]; the signer must already be dialing
    (or dial within accept_timeout)."""
    results = []
    client = SignerClient(laddr, accept_timeout=accept_timeout)
    await client.start()
    try:
        # 1. PubKey
        pub = client.get_pub_key()
        if expected_pubkey_hex and pub.bytes().hex() != expected_pubkey_hex.lower():
            raise HarnessFailure("PubKey", f"got {pub.bytes().hex()}")
        results.append(("PubKey", True, pub.bytes().hex()))

        addr = pub.address()
        height = int(time.time()) % 1_000_000 + 100  # fresh HRS per run

        # 2. SignProposal
        prop = Proposal(
            height=height,
            round=0,
            block_id=BlockID(b"\x01" * 32, PartSetHeader(1, b"\x02" * 32)),
            timestamp_ns=time.time_ns(),
        )
        await client.sign_proposal(CHAIN_ID, prop)
        if not pub.verify(prop.sign_bytes(CHAIN_ID), prop.signature):
            raise HarnessFailure("SignProposal", "signature does not verify")
        results.append(("SignProposal", True, ""))

        # 3. SignVote (prevote + precommit)
        for t, name in ((PREVOTE_TYPE, "prevote"), (PRECOMMIT_TYPE, "precommit")):
            v = _vote(addr, height, t, b"\x01" * 32)
            await client.sign_vote(CHAIN_ID, v)
            if not pub.verify(v.sign_bytes(CHAIN_ID), v.signature):
                raise HarnessFailure("SignVote", f"{name} signature does not verify")
        results.append(("SignVote", True, ""))

        # 4. DoubleSign: conflicting block at the same HRS must be refused
        try:
            await client.sign_vote(CHAIN_ID, _vote(addr, height, PRECOMMIT_TYPE, b"\x0f" * 32))
        except RemoteSignerError as e:
            results.append(("DoubleSign", True, f"refused: {e}"))
        else:
            raise HarnessFailure("DoubleSign", "conflicting vote was SIGNED")
    finally:
        await client.stop()
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="tm-signer-harness", description="remote signer acceptance tests"
    )
    ap.add_argument("--laddr", default="tcp://127.0.0.1:31559", help="listen for the signer here")
    ap.add_argument("--accept-timeout", type=float, default=30.0)
    ap.add_argument("--expected-pubkey", default="", help="hex ed25519 pubkey to require")
    args = ap.parse_args(argv)

    async def run():
        try:
            results = await run_harness(args.laddr, args.accept_timeout, args.expected_pubkey)
        except HarnessFailure as e:
            print(f"FAIL {e}")
            return 1
        except RemoteSignerError as e:
            print(f"FAIL connection: {e}")
            return 2
        for check, ok, detail in results:
            print(f"PASS {check}" + (f" ({detail})" if detail else ""))
        return 0

    return asyncio.run(run())


if __name__ == "__main__":
    sys.exit(main())
