"""Fast sync's pure parts: the Scheduler and the Processor with
verify_commit_run's cross-height batch (the port's copies of
tendermint_tpu/fastsync/scheduler.py and processor.py; the reactor needs
p2p, ROADMAP 1.7)."""

from .processor import Processor, verify_commit_run
from .scheduler import PeerInfo, Scheduler

__all__ = ["PeerInfo", "Processor", "Scheduler", "verify_commit_run"]
