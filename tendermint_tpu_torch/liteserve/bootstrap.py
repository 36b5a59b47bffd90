"""Snapshot-assisted bootstrap: reach the tip without walking from genesis
(the port's copy of tendermint_tpu/liteserve/bootstrap.py).

Reuses the statesync trust-root machinery (PR 4): the same
``TrustOptions(height, hash)`` subjective root statesync feeds its light
client, the same reachability/plausibility split (a dark primary is fatal,
a not-yet-served height is retryable), and — when the gateway is embedded
in a full node — the same ``EngineCommitPreverify`` lane through the
node's shared AsyncBatchVerifier.

The shared store comes up with TWO verified anchors: the trust-root header
itself and the chain tip (one bisection pass).  Every tenant request then
lands inside an already-verified span, so fresh tenants bisect against
cache hits instead of replaying the chain — the statesync argument applied
to light clients: trust is a root + a proof, not a replay.
"""

from __future__ import annotations

import asyncio
from typing import Optional

from ..libs.log import get_logger
from ..lite2 import Client, TrustOptions
from ..lite2.provider import ProviderError

log = get_logger("liteserve.bootstrap")


async def snapshot_bootstrap(client: Client, retries: int = 5, verify=None) -> int:
    """Initialize `client` at its trust root, then verify the primary's
    tip so the shared store spans [root, tip].  Returns the tip height.

    `verify` overrides the tip-verification callable — the gateway passes
    its witness-rotating, divergence-recovering path so a primary lying at
    bootstrap time is demoted exactly like one lying later.

    Bounded retries with backoff mirror statesync's trust-root fetch: the
    chain keeps moving while we bootstrap, and a header one block past the
    primary's serving window is seconds from existing — a dead primary is
    not."""
    if verify is None:
        verify = client.verify_header_at_height
    last_err: Optional[Exception] = None
    for attempt in range(retries):
        try:
            await client.initialize()
            latest = await client.primary.signed_header(0)
            if latest.height > client.store.latest_height():
                await verify(latest.height)
            tip = client.store.latest_height()
            log.info(
                "bootstrapped shared store",
                root=client.trust_options.height, tip=tip,
            )
            return tip
        except ProviderError as e:
            last_err = e
            await asyncio.sleep(0.3 * (attempt + 1))
    raise ProviderError(f"liteserve bootstrap failed after {retries} attempts: {last_err}")


async def trust_root_from_rpc(provider, height: int = 0) -> TrustOptions:
    """Operator convenience for dev rigs ONLY: derive a trust root from
    the primary itself (height 0 = two blocks below its tip, so the root
    is never ahead of any witness).  This trusts the primary at setup time
    — production tenants must supply their root out-of-band, exactly as
    statesync requires trust_height/trust_hash in config."""
    sh = await provider.signed_header(height)
    if height == 0 and sh.height > 2:
        sh = await provider.signed_header(sh.height - 2)
    return TrustOptions(
        period_ns=7 * 24 * 3600 * 1_000_000_000,
        height=sh.height,
        hash=sh.header.hash(),
    )
