"""The prefix-cache chain hash and the Retry-After helpers the engine
and gateway share (the stdlib subset of paddle_tpu/inference/router.py
this slice needs; the fleet router itself is not ported yet).

`chain_key` must stay bit-identical to the reference's: the fleet
router's affinity lookup and a replica's cache index hash a page the
same way only if both sides agree.
"""
from __future__ import annotations

import hashlib
import math
import struct

__all__ = ["chain_key", "RETRY_AFTER_CEILING_S"]

# upper clamp on any Retry-After hint (seconds)
RETRY_AFTER_CEILING_S = 60.0


def chain_key(parent: bytes, toks) -> bytes:
    """blake2b(parent_key, digest_size=16) over the page's token ids as
    little-endian int64; the chain root's parent is b""."""
    h = hashlib.blake2b(parent, digest_size=16)
    h.update(struct.pack("<%dq" % len(toks), *(int(t) for t in toks)))
    return h.digest()


def _clamp_retry(seconds: float) -> float:
    return max(0.01, min(float(seconds), RETRY_AFTER_CEILING_S))


def _retry_after_header(seconds: float) -> str:
    return str(max(1, math.ceil(_clamp_retry(seconds))))
