"""Deterministic proto3-style encodings for sign-bytes (copies of the JAX
package's varint.py and proto.py) and the registered-type storage codec
(codec.py) on the port's own msgpack subset (msgpack.py)."""
