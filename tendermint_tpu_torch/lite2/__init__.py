"""Light client (reference: lite2/) on the port's batch verifier.

The verification core is ValidatorSet.verify_commit /
verify_commit_trusting (types/validator.py), which route every signature
batch through the crypto.batch hooks — so a light client syncing a
10,000-validator chain verifies each header's commit as ONE kernel launch
on the card (BASELINE config #5).  The RPC-backed providers read a node
through the port's rpc clients; the lite2 proxy waits for ROADMAP 1.7.3.
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
