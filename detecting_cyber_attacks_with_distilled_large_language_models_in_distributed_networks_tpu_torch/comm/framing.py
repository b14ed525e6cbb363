"""Length-framed, CRC-checked frame transport over a socket (the port's copy).

The JAX package's ``comm/framing.py`` ``send_frame``/``recv_frame``, on the
same bytes, so the port's scoring server and client interoperate with the
JAX package's. Frame layout::

    MAGIC 'FTPF' | u64 payload length | u32 payload CRC-32 | payload

An ACK frame (``b"FTPK"``) follows a verified read unless both sides
disable it, as the scoring protocol does in both directions.
"""

from __future__ import annotations

import socket
import struct
import zlib

from .wire import WireError

FRAME_MAGIC = b"FTPF"  # fedtpu: allow(wire-magic-coverage): the JAX package's transport magic, copied byte for byte so both packages share one framing
ACK = b"FTPK"  # fedtpu: allow(wire-magic-coverage): the JAX package's transport ACK, copied byte for byte so both packages share one framing
SEND_CHUNK = 1 << 20  # 1 MB
RECV_CHUNK = 4 << 20  # 4 MB cap per recv
MAX_FRAME = 8 << 30  # sanity bound before allocating


def recv_exact(sock: socket.socket, n: int) -> bytearray:
    """Read exactly n bytes or raise ConnectionError."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:], min(n - got, RECV_CHUNK))
        if r == 0:
            raise ConnectionError(f"peer closed after {got}/{n} bytes")
        got += r
    return buf


def send_frame(
    sock: socket.socket, payload: bytes, *, await_ack: bool = True
) -> None:
    """Send one CRC'd frame in 1 MB chunks; wait for the receiver's ACK
    unless ``await_ack=False`` (the scoring protocol: the reply itself is
    the acknowledgment)."""
    crc = zlib.crc32(payload)
    sock.sendall(FRAME_MAGIC + struct.pack("<QI", len(payload), crc))
    view = memoryview(payload)
    for start in range(0, len(view), SEND_CHUNK):
        sock.sendall(view[start : start + SEND_CHUNK])
    if not await_ack:
        return
    ack = recv_exact(sock, len(ACK))
    if ack != ACK:
        raise WireError(f"bad ACK {ack!r}")


def recv_frame(
    sock: socket.socket,
    *,
    send_ack: bool = True,
    max_frame: int = MAX_FRAME,
) -> bytearray:
    """Receive one frame, verify its CRC, ACK it unless ``send_ack=False``,
    return the payload. ``max_frame`` bounds the allocation a peer can ask
    for before the payload is read."""
    header = recv_exact(sock, len(FRAME_MAGIC) + 12)
    if header[:4] != FRAME_MAGIC:
        raise WireError(f"bad frame magic {bytes(header[:4])!r}")
    length, crc = struct.unpack("<QI", header[4:])
    if length > min(max_frame, MAX_FRAME):
        raise WireError(
            f"frame length {length} exceeds {min(max_frame, MAX_FRAME)}"
        )
    payload = recv_exact(sock, length)
    got = zlib.crc32(payload)
    if got != crc:
        raise WireError(f"frame CRC mismatch (got {got:#010x}, want {crc:#010x})")
    if send_ack:
        sock.sendall(ACK)
    return payload
