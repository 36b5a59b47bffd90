"""Host-crypto tier probe: the port's copy of `active_tier` from
tendermint_tpu/crypto/backend.py.

The JAX package picks among three tiers for serial ed25519 work:
`cryptography` (OpenSSL), the project's C library, pure Python.  The port
has no `cryptography` tier (the card's machine lacks the package), so
tier 1 never reports here.  The rest of the module (the ciphers of the
secret connection, the mesh probe) comes with p2p, ROADMAP 1.7.
"""

from __future__ import annotations


def active_tier() -> int:
    """Best available host-crypto tier for serial ed25519 work: 2 = the
    project C library (csrc/sha512_batch.c), 3 = pure python.  Exported as
    the `tendermint_verify_backend_tier` gauge."""
    from . import hostprep

    return 2 if hostprep._load_lib() is not None else 3
