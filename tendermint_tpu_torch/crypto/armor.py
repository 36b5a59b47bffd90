"""ASCII armor for key material (the port's copy of
tendermint_tpu/crypto/armor.py).

Reference parity: crypto/armor/armor.go — OpenPGP-style ASCII armor
(RFC 4880 §6) used for exporting/importing keys: BEGIN/END lines, optional
headers, base64 body, CRC24 checksum line.
"""

from __future__ import annotations

import base64
import textwrap
from typing import Dict, Tuple

_CRC24_INIT = 0xB704CE
_CRC24_POLY = 0x1864CFB


def _crc24(data: bytes) -> int:
    crc = _CRC24_INIT
    for b in data:
        crc ^= b << 16
        for _ in range(8):
            crc <<= 1
            if crc & 0x1000000:
                crc ^= _CRC24_POLY
    return crc & 0xFFFFFF


def encode_armor(block_type: str, headers: Dict[str, str], data: bytes) -> str:
    lines = [f"-----BEGIN {block_type}-----"]
    for k, v in headers.items():
        lines.append(f"{k}: {v}")
    lines.append("")
    lines.extend(textwrap.wrap(base64.b64encode(data).decode(), 64))
    crc = base64.b64encode(_crc24(data).to_bytes(3, "big")).decode()
    lines.append(f"={crc}")
    lines.append(f"-----END {block_type}-----")
    return "\n".join(lines) + "\n"


def decode_armor(armor_str: str) -> Tuple[str, Dict[str, str], bytes]:
    """-> (block_type, headers, data); raises ValueError on malformed or
    checksum-failing input."""
    lines = [ln.rstrip("\r") for ln in armor_str.strip().splitlines()]
    if not lines or not lines[0].startswith("-----BEGIN ") or not lines[0].endswith("-----"):
        raise ValueError("missing armor BEGIN line")
    block_type = lines[0][len("-----BEGIN ") : -len("-----")]
    end = f"-----END {block_type}-----"
    if lines[-1] != end:
        raise ValueError("missing/mismatched armor END line")
    headers: Dict[str, str] = {}
    i = 1
    while i < len(lines) - 1 and lines[i]:
        if ":" not in lines[i]:
            break  # headerless armor goes straight to the body
        k, _, v = lines[i].partition(":")
        headers[k.strip()] = v.strip()
        i += 1
    if i < len(lines) - 1 and not lines[i]:
        i += 1
    body, crc_line = [], None
    for ln in lines[i:-1]:
        if ln.startswith("="):
            crc_line = ln[1:]
        elif ln:
            body.append(ln)
    try:
        data = base64.b64decode("".join(body), validate=True)
    except Exception as e:
        raise ValueError(f"bad armor body: {e}")
    if crc_line is not None:
        want = base64.b64decode(crc_line)
        if _crc24(data).to_bytes(3, "big") != want:
            raise ValueError("armor checksum mismatch")
    return block_type, headers, data
