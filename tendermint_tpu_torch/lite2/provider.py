"""Light-client providers: where signed headers and validator sets come
from (the port's copy of tendermint_tpu/lite2/provider.py).

Reference parity: lite2/provider/provider.go (Provider interface),
provider/http (RPC-backed), provider/mock.  LocalProvider additionally
wraps an in-proc node (the rpc/client/local pattern) for tests and for
serving a light proxy from a full node.
"""

from __future__ import annotations

from typing import Dict, Optional

from ..types.block import SignedHeader
from ..types.validator import Validator, ValidatorSet


class ProviderError(Exception):
    pass


class SignedHeaderNotFound(ProviderError):
    pass


class ValidatorSetNotFound(ProviderError):
    pass


class Provider:
    """lite2/provider/provider.go:9."""

    def chain_id(self) -> str:
        raise NotImplementedError

    async def signed_header(self, height: int) -> SignedHeader:
        """Height 0 means latest."""
        raise NotImplementedError

    async def validator_set(self, height: int) -> ValidatorSet:
        raise NotImplementedError


class MockProvider(Provider):
    """provider/mock — dict-backed fixtures."""

    def __init__(
        self,
        chain_id: str,
        headers: Optional[Dict[int, SignedHeader]] = None,
        vals: Optional[Dict[int, ValidatorSet]] = None,
    ):
        self._chain_id = chain_id
        self.headers = headers or {}
        self.vals = vals or {}

    def chain_id(self) -> str:
        return self._chain_id

    async def signed_header(self, height: int) -> SignedHeader:
        if height == 0 and self.headers:
            height = max(self.headers)
        sh = self.headers.get(height)
        if sh is None:
            raise SignedHeaderNotFound(f"no signed header at height {height}")
        return sh

    async def validator_set(self, height: int) -> ValidatorSet:
        if height == 0 and self.vals:
            height = max(self.vals)
        vs = self.vals.get(height)
        if vs is None:
            raise ValidatorSetNotFound(f"no validator set at height {height}")
        return vs


class _RPCProvider(Provider):
    """Shared logic for any rpc.BaseClient-compatible transport."""

    def __init__(self, chain_id: str, client):
        self._chain_id = chain_id
        self.client = client

    def chain_id(self) -> str:
        return self._chain_id

    async def signed_header(self, height: int) -> SignedHeader:
        try:
            res = await self.client.commit(None if height == 0 else height)
        except Exception as e:
            raise SignedHeaderNotFound(f"commit({height}): {e}") from e
        sh = res.get("signed_header")
        if sh is None:
            raise SignedHeaderNotFound(f"no signed header at height {height}")
        return sh

    async def validator_set(self, height: int) -> ValidatorSet:
        """Page through /validators and rebuild the full typed set."""
        vals: list = []
        page = 1
        try:
            while True:
                res = await self.client.validators(
                    None if height == 0 else height, page=page, per_page=100
                )
                vals.extend(Validator.from_dict(v) for v in res["validators"])
                if len(vals) >= res["total"] or not res["validators"]:
                    break
                page += 1
        except Exception as e:
            raise ValidatorSetNotFound(f"validators({height}): {e}") from e
        if not vals:
            raise ValidatorSetNotFound(f"empty validator set at height {height}")
        return ValidatorSet(vals)


class HTTPProvider(_RPCProvider):
    """provider/http — a remote node over the JSON-RPC client."""

    def __init__(self, chain_id: str, addr: str):
        from ..rpc.client import HTTPClient

        super().__init__(chain_id, HTTPClient(addr))

    async def close(self) -> None:
        await self.client.close()


class LocalProvider(_RPCProvider):
    """An in-proc node as provider (rpc/client/local substrate)."""

    def __init__(self, node):
        from ..rpc.client import LocalClient

        super().__init__(node.genesis_doc.chain_id, LocalClient(node))
