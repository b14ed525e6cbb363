"""Length-framed, CRC-checked frame transport over a socket (the port's copy).

The JAX package's ``comm/framing.py`` ``send_frame``/``recv_frame``, on the
same bytes, so the port's scoring server and client interoperate with the
JAX package's. Frame layout::

    MAGIC 'FTPF' | u64 payload length | u32 payload CRC-32 | payload

An ACK frame (``b"FTPK"``) follows a verified read unless both sides
disable it, as the scoring protocol and a stream's chunk frames do.
:class:`PipelinedSender` sends a stream's frames from a background thread
while the caller packs the next chunk; :func:`recv_stream` receives them,
handing each leaf over the moment its last byte lands.
"""

from __future__ import annotations

import queue
import socket
import struct
import threading
import time
from typing import Callable

from . import native, wire
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
    crc = native.crc32(payload)
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
    got = native.crc32(payload)
    if got != crc:
        raise WireError(f"frame CRC mismatch (got {got:#010x}, want {crc:#010x})")
    if send_ack:
        sock.sendall(ACK)
    return payload


class PipelinedSender:
    """Background frame writer: the streamed upload's wire half.

    The producer enqueues frame payloads; a thread drains the bounded
    queue through :func:`send_frame`, so packing chunk k+1 (a leaf's
    gather off the card and its encode) overlaps chunk k's socket write.
    ``depth`` bounds how far the packer runs ahead; the first send error
    is re-raised to the producer on its next :meth:`send` or on
    :meth:`close`, so a dead socket stops the pipeline within a chunk."""

    def __init__(self, sock: socket.socket, *, depth: int = 4):
        self._sock = sock
        self._q: queue.Queue = queue.Queue(maxsize=max(1, depth))
        self._err: BaseException | None = None
        self._send_s = 0.0  # seconds inside send_frame (wire time)
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            payload, await_ack = item
            if self._err is not None:
                continue  # drain, so the producer never blocks on put()
            t0 = time.monotonic()
            try:
                send_frame(self._sock, payload, await_ack=await_ack)
            except (OSError, WireError) as e:
                self._err = e
            finally:
                self._send_s += time.monotonic() - t0

    def send(self, payload: bytes, *, await_ack: bool = False) -> None:
        """Enqueue one frame (blocks while ``depth`` frames are pending);
        raises the wire thread's first error, if any."""
        if self._err is not None:
            raise self._err
        self._q.put((payload, await_ack))

    def close(self) -> float:
        """Flush the queue, join the thread, re-raise any send error;
        returns the wire thread's send seconds."""
        self._q.put(None)
        self._thread.join()
        if self._err is not None:
            raise self._err
        return self._send_s


def recv_stream(
    sock: socket.socket,
    tensors: list[dict],
    payload_nbytes: int,
    on_leaf: Callable[[dict, bytes], None],
    *,
    auth_key: bytes | None,
    nonce: bytes,
    direction: str,
) -> tuple[int, int]:
    """Receive a stream's chunk frames and its trailer, after its header:
    each chunk's tag is verified before its bytes are used, and each
    planned leaf's bytes go to ``on_leaf(tensor entry, bytes)`` the moment
    its last byte lands. The one receive loop of the streamed upload (the
    server) and the streamed reply (the client). Returns ``(chunks, bytes
    read)``."""
    ti = 0
    leaf = bytearray()

    def consume(data) -> None:
        nonlocal ti, leaf
        off = 0
        while True:
            while ti < len(tensors) and len(leaf) == int(tensors[ti]["nbytes"]):
                on_leaf(tensors[ti], bytes(leaf))
                leaf = bytearray()
                ti += 1
            if off >= len(data):
                return
            if ti >= len(tensors):
                raise WireError("stream carries bytes past its last tensor")
            take = min(int(tensors[ti]["nbytes"]) - len(leaf), len(data) - off)
            leaf += data[off : off + take]
            off += take

    consume(b"")  # zero-size leading leaves / an empty payload
    received = seq = got = 0
    while received < payload_nbytes:
        frame = recv_frame(sock, send_ack=False)
        got += len(frame)
        data = wire.decode_stream_chunk(
            frame, expect_seq=seq, auth_key=auth_key, nonce=nonce, direction=direction
        )
        if not data:
            # A well-formed sender never sends an empty chunk; taking them
            # would let a peer pin the receiver in a no-progress loop.
            raise WireError(f"empty stream chunk (seq {seq})")
        seq += 1
        if received + len(data) > payload_nbytes:
            raise WireError("stream overruns its declared payload size")
        received += len(data)
        consume(data)
    if ti != len(tensors) or leaf:
        raise WireError("stream ended mid-tensor")
    trailer = recv_frame(sock)  # ACKed: the upload-complete handshake
    got += len(trailer)
    wire.decode_stream_end(trailer, expect_chunks=seq, auth_key=auth_key, nonce=nonce, direction=direction)
    return seq, got
