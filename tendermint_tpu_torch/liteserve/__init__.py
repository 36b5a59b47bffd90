"""liteserve: multi-tenant light-client verification gateway (the port's
copy of tendermint_tpu/liteserve).

Serve thousands of bisecting light clients off ONE shared verification
engine: a shared LightStore + lite2 Client, a commit-level verification
cache with single-flight coalescing (cache.py), per-tenant trust-root
sessions with PR 11 overload discipline (sessions.py), witness-diversity
rotation with error-scored demotion (witness.py), and snapshot-assisted
bootstrap reusing the statesync trust-root machinery (bootstrap.py).
"""

from .bootstrap import snapshot_bootstrap, trust_root_from_rpc  # noqa: F401
from .cache import VerifyCache  # noqa: F401
from .service import LiteServe, run_service  # noqa: F401
from .sessions import Session, SessionManager  # noqa: F401
from .witness import WitnessPool  # noqa: F401
