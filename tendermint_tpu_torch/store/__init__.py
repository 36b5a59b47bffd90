"""The block store (the port's copy of tendermint_tpu/store)."""

from .block_store import BlockMeta, BlockStore, StoreCorruptionError, seal, unseal

__all__ = ["BlockMeta", "BlockStore", "StoreCorruptionError", "seal", "unseal"]
