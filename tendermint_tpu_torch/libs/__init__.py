"""Service lifecycle, flight recorder, metrics and bit arrays: the port's
copies of the parts of tendermint_tpu/libs the verify engine and VoteSet
use."""
