"""liteserve's shared verification cache: N light clients cost ONE commit
verification (the port's part of tendermint_tpu/liteserve)."""

from .cache import VerifyCache  # noqa: F401
