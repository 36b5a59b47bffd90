"""Service lifecycle, flight recorder, metrics, bit arrays and structured
logging: the port's copies of the parts of tendermint_tpu/libs the verify
engine, VoteSet and the light client use."""
