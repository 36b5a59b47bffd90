"""Light client (reference: lite2/) on the port's batch verifier.

The verification core is ValidatorSet.verify_commit /
verify_commit_trusting (types/validator.py), which route every signature
batch through the crypto.batch hooks — so a light client syncing a
10,000-validator chain verifies each header's commit as ONE kernel launch
on the card (BASELINE config #5).  The RPC-backed providers read a node
through the port's rpc clients; lite2/proxy.py serves the verified routes
over HTTP (the CLI's `light`).
"""

from .client import (  # noqa: F401
    BISECTION,
    SEQUENCE,
    Client,
    DivergedHeaderError,
    LightClientError,
    TrustOptions,
)
from .provider import (  # noqa: F401
    HTTPProvider,
    LocalProvider,
    MockProvider,
    Provider,
    ProviderError,
)
from .store import DBStore, MemStore  # noqa: F401
from .verifier import (  # noqa: F401
    ErrNewValSetCantBeTrusted,
    InvalidHeaderError,
    header_expired,
    verify,
    verify_adjacent,
    verify_non_adjacent,
)
