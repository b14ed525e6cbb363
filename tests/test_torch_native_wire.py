"""The wire's native byte path (``comm/native.py`` over
``native/fedwire.cpp``) held against the JAX package's
``comm/native.py``, on the CPU.

``crc32``, ``pack_bf16``, ``unpack_bf16`` and ``xor_bytes`` give the JAX
package's bytes on the same buffers (NaN payloads, ±inf, -0, subnormals,
round-to-even ties, every bf16 bit pattern, empty and odd-length
buffers) on the native path and on its numpy twin (the path a machine
without a C++ compiler takes); and the wire's frames (``encode``, stream
leaves and chunks, the framed transport) stay byte-equal to the JAX
package's with the native path active and with it absent.
"""

import socket
import threading
import zlib

import numpy as np
import pytest

from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.comm import (
    framing as jframing,
    native as jnative,
    wire as jwire,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.comm import (
    framing as pframing,
    native as pnative,
    wire as pwire,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.utils import (
    native as putils_native,
)

KEY = b"fedtpu-test-secret"
NONCE = bytes(range(16))


@pytest.fixture(params=["native", "numpy"])
def path(request, monkeypatch):
    """The native library (built here with g++) or, with it hidden, the
    numpy twins."""
    if request.param == "native":
        assert pnative.have_native(), putils_native.build_error("fedwire.cpp")
    else:
        monkeypatch.setattr(pnative, "lib", lambda: None)
        assert not pnative.have_native()
    return request.param


def _edge_values(n=9000, seed=0):
    rng = np.random.default_rng(seed)
    u = rng.normal(size=n).astype(np.float32).view(np.uint32)
    specials = np.array(
        [0x7F800001, 0x7FC12345, 0xFFC12345, 0xFF800001, 0x7FFFFFFF, 0xFFFFFFFF,  # NaNs
         0x7F800000, 0xFF800000, 0x00000000, 0x80000000,  # ±inf, ±0
         0x00000001, 0x007FFFFF, 0x80000001, 0x00008000, 0x807F8000,  # subnormals
         0x3F808000, 0x3F818000, 0xBF808000, 0x40018000, 0x00018000,  # ties to even
         0x3F807FFF, 0x3F808001, 0x7F7FFFFF, 0xFF7FFFFF, 0x7F7F8000],  # near ties, max
        np.uint32,
    )
    k = min(n, len(specials))
    u[:k] = specials[:k]
    return u.view(np.float32)


@pytest.mark.parametrize("n", [0, 1, 3, 7, 8, 9, 1001, 65537])
def test_crc32_matches_jax_and_zlib(path, n):
    data = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8)
    want = jnative.crc32(data)
    assert want == zlib.crc32(data.tobytes())
    for buf in (data, data.tobytes(), bytearray(data.tobytes()), memoryview(data.tobytes())):
        assert pnative.crc32(buf) == want
    for seed in (1, 0xFFFFFFFF, 0x1234ABCD):
        assert pnative.crc32(data, seed) == jnative.crc32(data, seed) == zlib.crc32(data.tobytes(), seed)
    # An fp32 array is checksummed over its raw bytes, in place.
    f = np.random.default_rng(1).normal(size=(n % 97) + 1).astype(np.float32)
    assert pnative.crc32(f) == jnative.crc32(np.frombuffer(f.tobytes(), np.uint8)) == zlib.crc32(f)


@pytest.mark.parametrize("shape", [(0,), (1,), (9000,), (3, 7), (5, 1, 3)])
def test_pack_bf16_matches_jax(path, shape):
    x = _edge_values(int(np.prod(shape)) if np.prod(shape) else 0, seed=len(shape)).reshape(shape)
    got = pnative.pack_bf16(x)
    assert got.dtype == np.uint16 and got.shape == x.shape
    np.testing.assert_array_equal(got, jnative.pack_bf16(x))
    np.testing.assert_array_equal(got, pnative.pack_bf16_numpy(x))
    if x.size >= 25:
        bits = x.reshape(-1).view(np.uint32)
        flat = got.reshape(-1)
        want = {
            0x7F800001: 0x7FC0, 0x7FC12345: 0x7FC1, 0xFFC12345: 0xFFC1, 0xFFFFFFFF: 0xFFFF,
            0x3F808000: 0x3F80, 0x3F818000: 0x3F82, 0xBF808000: 0xBF80, 0x00018000: 0x0002,
            0x80000000: 0x8000, 0x3F808001: 0x3F81, 0x7F7FFFFF: 0x7F80, 0x7F7F8000: 0x7F80,
        }
        for src, dst in want.items():
            assert int(flat[np.flatnonzero(bits == src)[0]]) == dst, hex(src)
    # A non-contiguous and a float64 input are packed as their fp32 values.
    y = np.asarray(x, np.float64)[..., ::-1]
    np.testing.assert_array_equal(pnative.pack_bf16(y), jnative.pack_bf16(y))


def test_unpack_bf16_matches_jax_on_every_pattern(path):
    allbits = np.arange(1 << 16, dtype=np.uint16)
    got = pnative.unpack_bf16(allbits)
    np.testing.assert_array_equal(got.view(np.uint32), jnative.unpack_bf16(allbits).view(np.uint32))
    np.testing.assert_array_equal(got.view(np.uint32), allbits.astype(np.uint32) << 16)
    assert pnative.unpack_bf16(allbits[:12], shape=(3, 4)).shape == (3, 4)
    assert pnative.unpack_bf16(np.zeros(0, np.uint16)).shape == (0,)
    # pack(unpack(b)) is b for every non-NaN pattern.
    finite = allbits[(allbits & 0x7FFF) <= 0x7F80]
    np.testing.assert_array_equal(pnative.pack_bf16(pnative.unpack_bf16(finite)), finite)


@pytest.mark.parametrize("n", [0, 1, 7, 8, 13, 4099])
def test_xor_bytes_matches_jax(path, n):
    rng = np.random.default_rng(n)
    src = rng.integers(0, 256, n, dtype=np.uint8)
    base = rng.integers(0, 256, n, dtype=np.uint8)
    a, b = base.copy(), base.copy()
    pnative.xor_bytes(src, a)
    jnative.xor_bytes(src, b)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a, base ^ src)
    pnative.xor_bytes(src, a)  # self-inverse
    np.testing.assert_array_equal(a, base)
    with pytest.raises(ValueError, match="equal-size uint8"):
        pnative.xor_bytes(src.astype(np.int8), a)
    with pytest.raises(ValueError, match="equal-size uint8"):
        pnative.xor_bytes(np.zeros(n + 1, np.uint8), a)


def _params(rng):
    return {
        "encoder": {"layer_0": {"kernel": _edge_values(33 * 17).reshape(33, 17)},
                    "bias": rng.normal(size=(5001,)).astype(np.float32)},
        "classifier": {"kernel": rng.normal(size=(8, 2)).astype(np.float32)},
        "count": np.arange(3, dtype=np.int32),
    }


@pytest.mark.parametrize("auth_key", [None, KEY], ids=["open", "hmac"])
@pytest.mark.parametrize("compression", ["none", "bf16"])
def test_wire_frames_stay_byte_equal(path, compression, auth_key):
    p = _params(np.random.default_rng(3))
    meta = {"client_id": 1, "n_samples": 9, "nonce": NONCE.hex()}
    blob = pwire.encode(p, meta=meta, compression=compression, auth_key=auth_key)
    assert blob == jwire.encode(p, meta=meta, compression=compression, auth_key=auth_key)
    _, got_meta = pwire.decode(blob, auth_key=auth_key)
    assert got_meta == meta
    flat = pwire.flatten_params(p)
    tensors, _ = pwire.plan_stream(pwire.flatten_lazy(flat), compression)
    payload = b"".join(pwire.encode_stream_leaf(flat[t["key"]], t["enc"]) for t in tensors)
    jtensors, _ = jwire.plan_stream(jwire.flatten_lazy(flat), compression)
    assert payload == b"".join(jwire.encode_stream_leaf(flat[t["key"]], t["enc"]) for t in jtensors)
    for seq in range(3):
        chunk = payload[seq * 999:(seq + 1) * 999]
        frame = pwire.encode_stream_chunk(seq, chunk, auth_key=auth_key, nonce=NONCE, direction="up")
        assert frame == jwire.encode_stream_chunk(seq, chunk, auth_key=auth_key, nonce=NONCE, direction="up")
    assert pwire.flat_crc32(flat) == jwire.flat_crc32(flat)
    # A tampered byte fails the CRC on the port's decode.
    bad = bytearray(blob)
    bad[-1] ^= 1
    with pytest.raises(pwire.WireError):
        pwire.decode(bytes(bad), auth_key=auth_key)


def test_framed_transport_interoperates(path):
    payload = _edge_values(4097).tobytes() + b"\x01\x02\x03"
    for send, recv in ((pframing, jframing), (jframing, pframing), (pframing, pframing)):
        a, b = socket.socketpair()
        try:
            got = {}
            t = threading.Thread(target=lambda: got.update(frame=recv.recv_frame(b)))
            t.start()
            send.send_frame(a, payload)
            t.join(10)
            assert bytes(got["frame"]) == payload
        finally:
            a.close()
            b.close()
    # A frame whose CRC is off is refused.
    a, b = socket.socketpair()
    try:
        header = pframing.FRAME_MAGIC + np.array([3], "<u8").tobytes() + np.array([zlib.crc32(b"abc") ^ 1], "<u4").tobytes()
        a.sendall(header + b"abc")
        with pytest.raises(pwire.WireError, match="CRC mismatch"):
            pframing.recv_frame(b)
    finally:
        a.close()
        b.close()
