"""Fast sync: the Scheduler, the Processor with verify_commit_run's
cross-height batch, and the BlockchainReactor that drives them over p2p
(the port's copies of tendermint_tpu/fastsync/)."""

from .processor import Processor, verify_commit_run
from .scheduler import PeerInfo, Scheduler
from .reactor import BLOCKCHAIN_CHANNEL, BlockchainReactor

__all__ = ["BLOCKCHAIN_CHANNEL", "BlockchainReactor", "PeerInfo", "Processor", "Scheduler",
           "verify_commit_run"]
