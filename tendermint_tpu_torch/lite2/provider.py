"""Light-client providers: where signed headers and validator sets come
from.  The port's copy of the provider interface and the mock provider of
tendermint_tpu/lite2/provider.py; the RPC-backed providers need an RPC
client, which the port does not have yet.

Reference parity: lite2/provider/provider.go (Provider interface),
provider/mock.
"""

from __future__ import annotations

from typing import Dict, Optional

from ..types.block import SignedHeader
from ..types.validator import ValidatorSet


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
