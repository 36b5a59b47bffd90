"""Deterministic proto3-style encodings for sign-bytes (copies of the JAX
package's varint.py and proto.py; the msgpack transport codec is not part
of the port)."""
