"""Service lifecycle, flight recorder, metrics, bit arrays, structured
logging, the kv store and StorageHealth: the port's copies of the parts of
tendermint_tpu/libs the verify engine, VoteSet, the light client and the
stores use."""
