"""Shamir secret sharing over GF(256), byte-wise.

The primitive under the full-Bonawitz double-masking secure aggregation
(comm/secure.py): each client Shamir-shares its self-mask seed and its DH
key seed at threshold ``t`` so the unmask round tolerates dropouts — any
``t`` of the ``n`` holders reconstruct, fewer learn nothing (each byte is
a degree ``t-1`` polynomial; ``t-1`` points leave the constant term
uniform).

Classic SSS in the AES field (x^8 + x^4 + x^3 + x + 1, 0x11b), one
polynomial per secret byte, share x-coordinates in 1..255 (here: client
id + 1, so ids must stay < 255). Secrets are short (32-byte seeds), so
the pure-Python field arithmetic is microseconds per share; the reference
has no secret sharing (or any cryptography) at all — its server reads raw
weights off the wire (reference server.py:57-65).
"""

from __future__ import annotations

import os
from typing import Iterable, Mapping

# exp/log tables for GF(2^8) with the AES reduction polynomial; generator 3.
_EXP = [0] * 512
_LOG = [0] * 256
_x = 1
for _i in range(255):
    _EXP[_i] = _x
    _LOG[_x] = _i
    # multiply by the generator 0x03 = x + 1: x*3 = (x<<1) ^ x
    _x = (_x << 1) ^ _x
    if _x & 0x100:
        _x ^= 0x11B
for _i in range(255, 512):
    _EXP[_i] = _EXP[_i - 255]


def _mul(a: int, b: int) -> int:
    if a == 0 or b == 0:
        return 0
    return _EXP[_LOG[a] + _LOG[b]]


def _inv(a: int) -> int:
    if a == 0:
        raise ZeroDivisionError("no inverse of 0 in GF(256)")
    return _EXP[255 - _LOG[a]]


class ShamirError(ValueError):
    """Malformed shares or parameters."""


def split(
    secret: bytes,
    xs: Iterable[int],
    threshold: int,
    *,
    rng: "os.urandom.__class__ | None" = None,
) -> dict[int, bytes]:
    """Share ``secret`` to the holders at x-coordinates ``xs`` (distinct,
    in 1..255) so any ``threshold`` of them reconstruct it. ``rng``
    overrides the coefficient sampler (os.urandom) for tests ONLY —
    deterministic coefficients void the secrecy guarantee."""
    xs = [int(x) for x in xs]
    n = len(xs)
    if len(set(xs)) != n:
        raise ShamirError(f"duplicate share x-coordinates: {sorted(xs)}")
    if not all(1 <= x <= 255 for x in xs):
        raise ShamirError(f"share x-coordinates must be in 1..255: {sorted(xs)}")
    if not 1 <= threshold <= n:
        raise ShamirError(f"threshold {threshold} out of range [1, {n}]")
    draw = os.urandom if rng is None else rng
    shares = {x: bytearray(len(secret)) for x in xs}
    for bi, s in enumerate(secret):
        # f(0) = secret byte; higher coefficients uniform.
        coeffs = [s] + list(draw(threshold - 1))
        for x in xs:
            y = 0
            for c in reversed(coeffs):  # Horner in GF(256)
                y = _mul(y, x) ^ c
            shares[x][bi] = y
    return {x: bytes(v) for x, v in shares.items()}


def combine(shares: Mapping[int, bytes]) -> bytes:
    """Reconstruct the secret from ``>= threshold`` shares (Lagrange at 0).
    Passing more than ``threshold`` consistent shares is fine — they lie
    on the same polynomial; inconsistent or too-few shares reconstruct
    garbage, which callers must detect semantically (the double-masking
    server verifies reconstructed DH seeds against the dealt public
    keys, comm/secure.py)."""
    if not shares:
        raise ShamirError("no shares to combine")
    xs = [int(x) for x in shares]
    if not all(1 <= x <= 255 for x in xs):
        raise ShamirError(f"share x-coordinates must be in 1..255: {sorted(xs)}")
    lengths = {len(v) for v in shares.values()}
    if len(lengths) != 1:
        raise ShamirError(f"inconsistent share lengths: {sorted(lengths)}")
    (length,) = lengths
    # Lagrange basis at 0 depends only on the x set — compute once.
    lag = []
    for j, xj in enumerate(xs):
        num = den = 1
        for m, xm in enumerate(xs):
            if m != j:
                num = _mul(num, xm)
                den = _mul(den, xj ^ xm)
        lag.append(_mul(num, _inv(den)))
    out = bytearray(length)
    ys = [shares[x] for x in xs]
    for bi in range(length):
        acc = 0
        for lj, y in zip(lag, ys):
            acc ^= _mul(y[bi], lj)
        out[bi] = acc
    return bytes(out)
