"""The port's lossy wires, HMAC and stream frames held against the JAX
package's, byte for byte, on the CPU.

* ``encode`` under bf16, int8, int8c and ``topk:0.01``, with and without an
  auth key, returns the JAX package's bytes; each side decodes the other's
  frames to ``array_equal`` values;
* every stream frame (header, chunk, trailer; upload and reply direction)
  is byte-equal for a fixed nonce and key, and decodes on the other side;
* the codecs' edge cases (NaN with payloads, ±inf, all-zero chunks,
  denormals, values halfway between two bf16 values, ties for top-k) give
  exactly equal outputs; malformed or poisoned payloads raise
  ``WireError`` on both sides;
* a tampered tag, a missing tag, a wrong key or a reflected upload chunk is
  rejected.
"""

import struct

import numpy as np
import pytest

from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.comm import (
    native as jnative,
    quant as jquant,
    wire as jwire,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.comm import (
    quant as pquant,
    wire as pwire,
)

KEY = b"fedtpu-test-secret"
NONCE = bytes(range(16))


def _params(rng):
    return {
        "encoder": {
            "layer_0": {"kernel": rng.normal(size=(33, 17)).astype(np.float32)},
            "bias": rng.normal(size=(5000,)).astype(np.float32) * 1e-3,
        },
        "classifier": {"kernel": rng.normal(size=(8, 2)).astype(np.float32)},
        "count": np.arange(3, dtype=np.int32),
        "scalar": np.float32(2.5),
    }


def _edge_values(rng, n=9000):
    """fp32 with NaNs carrying payloads, ±inf, ±0, denormals, values
    exactly halfway between two bf16 values (both parities), the largest
    finite fp32 (rounds to inf in bf16) and ordinary noise."""
    u = rng.normal(size=n).astype(np.float32).view(np.uint32)
    specials = np.array(
        [0x7F800001, 0x7FC12345, 0xFFC12345, 0xFF800001, 0x7FFFFFFF,  # NaNs
         0x7F800000, 0xFF800000, 0x00000000, 0x80000000,  # ±inf, ±0
         0x00000001, 0x007FFFFF, 0x80000001, 0x00008000,  # denormals
         0x3F808000, 0x3F818000, 0xBF808000, 0x40018000,  # exact halfway
         0x3F807FFF, 0x3F808001, 0x7F7FFFFF, 0xFF7FFFFF],  # near halfway, max
        np.uint32,
    )
    u[: len(specials)] = specials
    u[4096:8192] = 0  # an all-zero int8c chunk
    return u.view(np.float32)


def _assert_same_tree(a, b):
    fa, fb = pwire.flatten_params(a), jwire.flatten_params(b)
    assert list(fa) == list(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and fa[k].shape == fb[k].shape, k
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


@pytest.mark.parametrize("auth_key", [None, KEY], ids=["open", "hmac"])
@pytest.mark.parametrize("compression", ["none", "bf16", "int8", "int8c", "topk:0.01"])
def test_encode_is_byte_equal_and_cross_decodes(compression, auth_key):
    rng = np.random.default_rng(11)
    p = _params(rng)
    p["edges"] = _edge_values(rng) if compression == "bf16" else rng.normal(size=9000).astype(np.float32)
    meta = {"client_id": 2, "n_samples": 40, "role": "client", "nonce": NONCE.hex()}
    blob = pwire.encode(p, meta=meta, compression=compression, auth_key=auth_key)
    assert blob == jwire.encode(p, meta=meta, compression=compression, auth_key=auth_key)
    jtree, jmeta = jwire.decode(blob, auth_key=auth_key)
    ptree, pmeta = pwire.decode(blob, auth_key=auth_key)
    assert pmeta == jmeta == meta
    _assert_same_tree(ptree, jtree)


def test_bf16_pack_is_fedwire_bit_for_bit():
    """The port's numpy pack against the JAX package's (native/fedwire.cpp)
    and against the expected bits of the hard cases."""
    x = _edge_values(np.random.default_rng(12))
    got = pwire.pack_bf16(x)
    np.testing.assert_array_equal(got, jnative.pack_bf16(x))
    want = {
        0x7F800001: 0x7FC0, 0x7FC12345: 0x7FC1, 0xFFC12345: 0xFFC1,  # NaN payload, quiet bit
        0x3F808000: 0x3F80, 0x3F818000: 0x3F82, 0xBF808000: 0xBF80,  # ties to even
        0x3F808001: 0x3F81, 0x7F7FFFFF: 0x7F80, 0x00000001: 0x0000,
    }
    bits = x.view(np.uint32)
    for src, dst in want.items():
        assert int(got[np.flatnonzero(bits == src)[0]]) == dst, hex(src)
    back = pwire.unpack_bf16(got)
    np.testing.assert_array_equal(back.view(np.uint32), jnative.unpack_bf16(got).view(np.uint32))


def test_int8c_and_int8_codecs_match_on_edge_cases():
    rng = np.random.default_rng(13)
    cases = [
        _edge_values(rng),
        np.zeros(5000, np.float32),
        np.full(4097, np.float32(1e-42)),  # denormal chunk: scale underflows -> 1.0
        np.array([np.inf, -np.inf, np.nan, 1.0], np.float32),
        np.zeros((0,), np.float32),
        rng.normal(size=(7, 300)).astype(np.float32),
    ]
    for x in cases:
        with np.errstate(invalid="ignore", over="ignore"):
            pq, jq = pquant.quantize_int8c(x), jquant.quantize_int8c(x)
        assert pq == jq
        np.testing.assert_array_equal(pquant.dequantize_int8c(pq, x.shape), jquant.dequantize_int8c(jq, x.shape))
        if np.isfinite(x).all():
            assert pwire.quantize_int8(x) == jwire.quantize_int8(x)
            np.testing.assert_array_equal(
                pwire.dequantize_int8(pwire.quantize_int8(x), x.shape),
                jwire.dequantize_int8(jwire.quantize_int8(x), x.shape),
            )
    assert pquant.int8c_nbytes(4097) == jquant.int8c_nbytes(4097) == 8 + 4097


def test_topk_selection_with_ties_is_byte_equal():
    x = np.array([3, -3, 3, 1, -3, 3, 0, 2] * 300, np.float32)  # many ties
    for frac in (0.01, 0.1, 0.5, 1.0):
        assert pwire.sparsify_topk(x, frac) == jwire.sparsify_topk(x, frac)
    buf = pwire.sparsify_topk(x, 0.01)
    k = struct.unpack("<I", buf[:4])[0]
    assert k == max(1, round(0.01 * x.size))
    np.testing.assert_array_equal(pwire.densify_topk(buf, x.shape), jwire.densify_topk(buf, x.shape))


@pytest.mark.parametrize(
    "bad",
    [
        ("int8c", lambda raw: raw[:-1]),  # truncated
        ("int8c", lambda raw: np.float32(np.nan).tobytes() + raw[4:]),  # poisoned scale
        ("int8c", lambda raw: np.float32(-1.0).tobytes() + raw[4:]),  # negative scale
        ("int8", lambda raw: raw + b"\0"),  # long
        ("topk", lambda raw: raw[:3]),  # no count
        ("topk", lambda raw: struct.pack("<I", 10**6) + raw[4:]),  # count > size
        ("topk", lambda raw: raw[:4] + struct.pack("<i", -1) + raw[8:]),  # index < 0
        ("topk", lambda raw: raw[:4] + struct.pack("<i", 9000) + raw[8:]),  # index >= size
    ],
)
def test_malformed_payloads_raise_wire_error_on_both_sides(bad):
    enc, corrupt = bad
    x = np.random.default_rng(14).normal(size=(3, 3000)).astype(np.float32)
    raw = {"int8c": pquant.quantize_int8c, "int8": pwire.quantize_int8,
           "topk": lambda a: pwire.sparsify_topk(a, 0.01)}[enc](x)
    t = {"key": "w", "dtype": "float32", "shape": list(x.shape), "enc": enc}
    for mod in (pwire, jwire):
        with pytest.raises(mod.WireError):
            mod.decode_tensor_entry(t, corrupt(raw))
    # A topk tensor claiming a huge dense shape is refused before allocating.
    t = {"key": "w", "dtype": "float32", "shape": [1 << 40], "enc": "topk"}
    for mod in (pwire, jwire):
        with pytest.raises(mod.WireError, match="dense size"):
            mod.decode_tensor_entry(t, struct.pack("<I", 0))


def test_auth_rejects_tampered_missing_and_wrong_key():
    p = _params(np.random.default_rng(15))
    signed = pwire.encode(p, meta={"a": 1}, auth_key=KEY)
    unsigned = pwire.encode(p, meta={"a": 1})
    tampered = bytearray(signed)
    tampered[-40] ^= 0x01  # a payload byte under the tag
    for mod in (pwire, jwire):
        with pytest.raises(mod.WireError, match="HMAC"):
            mod.decode(bytes(tampered), auth_key=KEY)
        with pytest.raises(mod.WireError, match="HMAC"):
            mod.decode(signed, auth_key=b"wrong key")
        with pytest.raises(mod.WireError, match="unauthenticated"):
            mod.decode(unsigned, auth_key=KEY)
        # The tag stripped: its place is taken by payload bytes.
        with pytest.raises(mod.WireError, match="HMAC"):
            mod.decode(signed[: -pwire.AUTH_TAG_LEN], auth_key=KEY)
        # A keyless side reads an authenticated message (the tag is skipped).
        _assert_same_tree(mod.decode(signed)[0], jwire.decode(signed, auth_key=KEY)[0])


@pytest.mark.parametrize("direction", ["up", "down"])
@pytest.mark.parametrize("auth_key", [None, KEY], ids=["open", "hmac"])
@pytest.mark.parametrize("compression", ["none", "bf16", "int8", "int8c"])
def test_stream_frames_are_byte_equal_and_cross_decode(compression, auth_key, direction):
    rng = np.random.default_rng(16)
    flat = pwire.flatten_params(_params(rng))
    ptensors, pn = pwire.plan_stream(pwire.flatten_lazy(flat), compression)
    jtensors, jn = jwire.plan_stream(jwire.flatten_lazy(flat), compression)
    assert (ptensors, pn) == (jtensors, jn)
    meta = {"client_id": 1, "role": "client", "nonce": NONCE.hex(), "wire_dtype": "int8"}
    hdr = pwire.encode_stream_header(ptensors, meta=meta, chunk_bytes=1000, payload_nbytes=pn,
                                     auth_key=auth_key, direction=direction)
    assert hdr == jwire.encode_stream_header(jtensors, meta=meta, chunk_bytes=1000, payload_nbytes=jn,
                                             auth_key=auth_key, direction=direction)
    for mod in (pwire, jwire):
        assert mod.decode_stream_header(hdr, auth_key=auth_key, direction=direction) == (ptensors, meta, 1000, pn)
    payload = b"".join(pwire.encode_stream_leaf(flat[t["key"]], t["enc"]) for t in ptensors)
    assert payload == b"".join(jwire.encode_stream_leaf(flat[t["key"]], t["enc"]) for t in jtensors)
    chunks = [payload[i : i + 1000] for i in range(0, len(payload), 1000)]
    for seq, chunk in enumerate(chunks):
        frame = pwire.encode_stream_chunk(seq, chunk, auth_key=auth_key, nonce=NONCE, direction=direction)
        assert frame == jwire.encode_stream_chunk(seq, chunk, auth_key=auth_key, nonce=NONCE, direction=direction)
        for mod in (pwire, jwire):
            got = mod.decode_stream_chunk(frame, expect_seq=seq, auth_key=auth_key, nonce=NONCE, direction=direction)
            assert bytes(got) == chunk
    end = pwire.encode_stream_end(len(chunks), auth_key=auth_key, nonce=NONCE, direction=direction)
    assert end == jwire.encode_stream_end(len(chunks), auth_key=auth_key, nonce=NONCE, direction=direction)
    for mod in (pwire, jwire):
        mod.decode_stream_end(end, expect_chunks=len(chunks), auth_key=auth_key, nonce=NONCE, direction=direction)
    # The leaves the payload carries decode to the same values on both sides.
    for t in ptensors:
        raw = payload[t["offset"] : t["offset"] + t["nbytes"]]
        np.testing.assert_array_equal(pwire.decode_tensor_entry(t, raw), jwire.decode_tensor_entry(t, raw))


def test_stream_frames_reject_reflection_tampering_and_bad_plans():
    rng = np.random.default_rng(17)
    flat = pwire.flatten_params(_params(rng))
    tensors, n = pwire.plan_stream(flat, "none")
    chunk = pwire.encode_stream_chunk(0, b"abc", auth_key=KEY, nonce=NONCE, direction="up")
    hdr = pwire.encode_stream_header(tensors, meta={}, chunk_bytes=8, payload_nbytes=n, auth_key=KEY, direction="up")
    end = pwire.encode_stream_end(1, auth_key=KEY, nonce=NONCE, direction="up")
    for mod in (pwire, jwire):
        # An upload frame reflected back as a reply never verifies.
        with pytest.raises(mod.WireError, match="HMAC"):
            mod.decode_stream_chunk(chunk, expect_seq=0, auth_key=KEY, nonce=NONCE, direction="down")
        with pytest.raises(mod.WireError, match="HMAC"):
            mod.decode_stream_header(hdr, auth_key=KEY, direction="down")
        with pytest.raises(mod.WireError, match="HMAC"):
            mod.decode_stream_end(end, expect_chunks=1, auth_key=KEY, nonce=NONCE, direction="down")
        # Another connection's nonce, a wrong key, a missing tag, a reorder.
        with pytest.raises(mod.WireError, match="HMAC"):
            mod.decode_stream_chunk(chunk, expect_seq=0, auth_key=KEY, nonce=bytes(16), direction="up")
        with pytest.raises(mod.WireError, match="HMAC"):
            mod.decode_stream_chunk(chunk, expect_seq=0, auth_key=b"other", nonce=NONCE, direction="up")
        with pytest.raises(mod.WireError, match="auth tag"):
            mod.decode_stream_header(hdr[:-32], auth_key=KEY, direction="up")
        with pytest.raises(mod.WireError, match="out of order"):
            mod.decode_stream_chunk(chunk, expect_seq=1, auth_key=KEY, nonce=NONCE, direction="up")
        with pytest.raises(mod.WireError, match="claims"):
            mod.decode_stream_end(end, expect_chunks=2, auth_key=KEY, nonce=NONCE, direction="up")
        with pytest.raises(mod.WireError, match="direction"):
            mod.decode_stream_chunk(chunk, expect_seq=0, direction="sideways")
        with pytest.raises(mod.WireError, match="data-dependent"):
            mod.plan_stream(flat, "topk:0.1")
    # Non-contiguous extents and non-streamable encodings are refused.
    broken = [dict(t) for t in tensors]
    broken[1]["offset"] += 4
    bad_enc = [dict(t) for t in tensors]
    bad_enc[0]["enc"] = "topk"
    for table in (broken, bad_enc):
        blob = jwire.encode_stream_header(table, meta={}, chunk_bytes=8, payload_nbytes=n, direction="up")
        for mod in (pwire, jwire):
            with pytest.raises(mod.WireError):
                mod.decode_stream_header(blob, direction="up")
