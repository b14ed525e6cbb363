"""Secure aggregation for the cross-host TCP mode: pairwise masking (the
port's copy of the JAX package's ``comm/secure.py``: host numpy, the same
frames and the same Philox mask streams, so a JAX client's masks and a
port client's cancel in one round).

In the reference every client ships its raw state dict to the server, which
can read each client's exact weights (reference server.py:57-65) — the
aggregate is the only thing clients intend to reveal, but the server learns
far more. This module implements the canonical fix (the pairwise-mask
construction of Bonawitz et al., "Practical Secure Aggregation for
Privacy-Preserving Machine Learning", CCS 2017, in its simplest
all-parties-survive form):

* every client quantizes its weights to fixed point (``fp_bits`` fractional
  bits) in the ring Z_2^64,
* each pair of clients (i, j) derives the same mask stream from a shared
  mask secret (which the server does NOT hold): client min(i,j) adds the
  stream, client max(i,j) subtracts it, all mod 2^64,
* the server sums the masked uint64 uploads — the masks cancel exactly in
  modular arithmetic — and recovers the plain fixed-point sum, which it
  de-quantizes into the mean.

Properties: the server (and any wire observer) sees each upload as
uniformly random ring elements; the sum over ALL participants is exact
(bit-exact modular cancellation, no float cancellation error); the only
loss vs plain FedAvg is the fixed-point quantization, 2^-fp_bits per
weight. Mask streams are domain-separated by a per-server-run random
``session`` nonce plus the advertised round number, so a stream is never
reused across rounds or server restarts; a client instance additionally
refuses a (session, round) it has already masked different weights for.

Threat model: honest-but-curious server and passive wire observers (the
semi-honest setting of the Bonawitz paper). Pairwise streams derive from
PER-PAIR Diffie-Hellman secrets (fresh ephemeral keypairs every round,
public keys relayed through the server): client i holds only the secrets
of pairs it belongs to, so no PASSIVE party — a curious client reading
transcripts, or anyone holding a leaked client's key material — can
regenerate another pair's stream or unmask a third party's upload;
compromising one client reveals only that client's own masks. Precise
limits of the guarantee:

* ACTIVE in-group adversaries: with per-client keys provisioned
  (``AggregationServer(client_keys={id: key})`` +
  ``FederatedClient(client_key=...)``; CLI ``FEDTPU_CLIENT_SECRETS`` /
  ``FEDTPU_CLIENT_SECRET``) each DH hello is HMAC-bound by that client's
  OWN key, so a malicious member cannot impersonate another id in the
  key exchange — the forgery fails closed at the server. Reveal
  request/response frames likewise ride the per-client key when
  provisioned (request tagged under the recipient survivor's key,
  response under the sender's), so an in-group active adversary holding
  only the group key can neither forge a REVEAL_REQ naming a victim
  that actually uploaded (to harvest its pair secrets from survivors)
  nor spoof a survivor's response. The server re-tags verified keys
  under the group key for the relay (receivers hold the group key, not
  each other's). With only the group key, the HMAC proves membership,
  not identity, and the in-group impersonation race remains
  (first-registration-wins limits, not removes, it). A client-side
  ``min_participants`` floor (default: the full fleet) additionally
  stops a compromised server/MITM from shrinking a client's
  mask-partner set to a colluding singleton.
* A MALICIOUS (not just curious) server can substitute public keys in
  transit — it verifies and re-signs the relay, so per-client keys do
  not constrain it. This is the one remaining active adversary;
  removing it needs client-to-client signatures (full Bonawitz PKI).
* WITHOUT a group auth key (``FEDTPU_SECRET`` unset) the exchange has no
  integrity at all: an active on-path attacker can MITM the relay and
  unmask every upload. No-auth secure-agg protects against passive
  observers only; the client logs a warning.
* Client dropout recovery — two protocols, selected by
  ``secure_protocol`` and pinned by the client (a mismatched advert is
  refused, so a malicious server cannot downgrade):

  **"double" (default): full Bonawitz §6 double-masking.** Every upload
  additionally carries a self-mask stream from a per-round seed b_i, and
  each client Shamir-shares both b_i and its DH key seed among the keyed
  participants at threshold t (default: strict majority), the share
  blobs relayed through the server encrypted+MAC'd under the pair
  secrets. Recovery layers:

  - dropout BEFORE key distribution: the key set U1 finalizes at the
    quorum whose hellos arrived within the grace window (as before).
  - dropout AFTER keys but BEFORE share distribution: the
    share-complete set U2 finalizes at the dealers that delivered;
    nobody has masked against the missing yet, so the round proceeds.
  - dropout AFTER shares but before upload: the unmask round
    reconstructs the dead client's key seed from any t holders'
    shares (verified against its registered public key), regenerates
    its pair masks, and subtracts them from the ring sum.
  - dropout DURING the unmask round: tolerated while t holders keep
    answering — reconstruction needs any t shares, not everyone.

  The FALSE-DEATH attack of the reveal variant is closed: an honest
  holder reveals, per dealer, EITHER its b-share (dealer claimed alive)
  OR its key-seed share (claimed dead), never both — and the parse
  refuses overlapping claims. With the majority threshold, assembling t
  shares of both kinds for one dealer would need more answers than
  there are holders, so a server that received client j's upload yet
  declares j dead reconstructs j's pair masks but NOT j's self-mask:
  the upload stays hidden. (A malicious server sending DIFFERENT
  alive/dead partitions to different holders is bounded by the same
  counting argument; full resistance to arbitrary active servers still
  needs the consistency-check signatures of Bonawitz §7, out of scope
  with the rest of the active-server vector above.) Reconstructed
  self-mask seeds are verified against dealt commitments, so corrupted
  shares fail loudly rather than silently skewing the aggregate.

  **"reveal": the cheaper variant** (no shares, no self-masks;
  an unmask round only when someone died). Survivors disclose their
  per-pair DH secrets with the dead (``REVEAL_REQ``); per-round
  keypairs mean a revealed secret unlocks only that round's
  (survivor, dead) streams, and the dead contributed nothing to the
  sum. Known limits (why "double" is the default): the false-death
  unmask above, and a dropout DURING the reveal phase fails the round.
"""

from __future__ import annotations

import hashlib
import os
import struct
from typing import Mapping, Sequence

import numpy as np

from .wire import (
    REVEAL_MAGIC,
    REVEAL_RESP_MAGIC,
    SHARES_MAGIC,
    SHARESET_MAGIC,
    UNMASK_MAGIC,
    UNMASK_RESP_MAGIC,
)

#: Default fractional bits. 2^-24 ~ 6e-8 absolute quantization error per
#: weight — far below bf16 wire compression and Adam-step noise.
DEFAULT_FP_BITS = 24

_DOMAIN = b"fedtpu-secagg-v2"

# RFC 3526 group 14: 2048-bit MODP, generator 2 — finite-field DH from the
# stdlib alone (pow(g, x, P); no external crypto dependency in this image).
DH_PRIME = int(
    "FFFFFFFFFFFFFFFFC90FDAA22168C234C4C6628B80DC1CD129024E088A67CC74"
    "020BBEA63B139B22514A08798E3404DDEF9519B3CD3A431B302B0A6DF25F1437"
    "4FE1356D6D51C245E485B576625E7EC6F44C42E9A637ED6B0BFF5CB6F406B7ED"
    "EE386BFB5A899FA5AE9F24117C4B1FE649286651ECE45B3DC2007CB8A163BF05"
    "98DA48361C55D39A69163FA8FD24CF5F83655D23DCA3AD961C62F356208552BB"
    "9ED529077096966D670C354E4ABC9804F1746C08CA18217C32905E462E36CE3B"
    "E39E772C180E86039B2783A2EC07A28FB5C55DF06F4C52C9DE2BCBF695581718"
    "3995497CEA956AE515D2261898FA051015728E5A8AACAA68FFFFFFFFFFFFFFFF",
    16,
)
DH_GENERATOR = 2
DH_PUB_LEN = 256  # 2048-bit public values, fixed-width big-endian


def dh_keypair(entropy: bytes | None = None) -> tuple[int, bytes]:
    """Fresh ephemeral DH keypair: (private exponent, 256-byte public).

    256-bit private exponents — standard for a 2048-bit MODP group
    (~112-bit security either way). ``entropy`` pins the key for tests."""
    raw = os.urandom(32) if entropy is None else hashlib.sha256(entropy).digest()
    x = int.from_bytes(raw, "big") | (1 << 255)  # top bit set: full length
    y = pow(DH_GENERATOR, x, DH_PRIME)
    return x, y.to_bytes(DH_PUB_LEN, "big")


def check_dh_public(pub: bytes) -> int:
    """Parse + validate a peer public value; rejects the degenerate
    elements (0, 1, p-1, >= p) that would collapse the shared secret."""
    if len(pub) != DH_PUB_LEN:
        raise SecureAggError(f"DH public value is {len(pub)} bytes, want {DH_PUB_LEN}")
    y = int.from_bytes(pub, "big")
    if not 2 <= y <= DH_PRIME - 2:
        raise SecureAggError("degenerate DH public value")
    return y


def dh_pair_secret(private: int, peer_pub: bytes) -> bytes:
    """The (i, j) pair's shared mask secret: SHA-256 of the fixed-width
    DH shared value. Symmetric — both ends derive the same bytes; nobody
    without one of the two private exponents can."""
    shared = pow(check_dh_public(peer_pub), private, DH_PRIME)
    return hashlib.sha256(
        _DOMAIN + b"-dh" + shared.to_bytes(DH_PUB_LEN, "big")
    ).digest()


def pubkey_tag(
    auth_key: bytes, session: bytes, round_index: int, client_id: int, pub: bytes
) -> bytes:
    """HMAC binding a relayed public key to (session, round, client id):
    protects the DH exchange against tampering by anyone WITHOUT the group
    auth key (the server holds it, so server MITM stays out of scope —
    see the module threat model)."""
    import hmac

    return hmac.new(
        auth_key,
        _DOMAIN + b"-pk" + session + struct.pack("<Qq", round_index, client_id) + pub,
        hashlib.sha256,
    ).digest()


def verify_pubkey_tag(
    auth_key: bytes,
    session: bytes,
    round_index: int,
    client_id: int,
    pub: bytes,
    tag: bytes,
) -> None:
    """Constant-time check of :func:`pubkey_tag`; raises on mismatch.
    The single verification used by BOTH the server (on hellos) and the
    client (on the relayed keys frame), so the binding can never drift
    between the two ends."""
    import hmac

    if not hmac.compare_digest(
        tag, pubkey_tag(auth_key, session, round_index, client_id, pub)
    ):
        raise SecureAggError(
            f"DH public key for client {client_id} failed its authenticity "
            "check — possible tampering"
        )


class SecureAggError(ValueError):
    """Inconsistent secure-aggregation round (participants/format)."""


def quantize(flat: Mapping[str, np.ndarray], fp_bits: int = DEFAULT_FP_BITS) -> dict[str, np.ndarray]:
    """float32 params -> fixed-point ring elements (uint64, two's complement)."""
    scale = float(1 << fp_bits)
    out = {}
    for key in sorted(flat):
        arr = np.asarray(flat[key])
        if not np.issubdtype(arr.dtype, np.floating):
            raise SecureAggError(f"tensor {key!r} is {arr.dtype}, expected float")
        q = np.round(arr.astype(np.float64) * scale).astype(np.int64)
        out[key] = q.view(np.uint64)
    return out


def dequantize_sum(
    summed: Mapping[str, np.ndarray], n_clients: int, fp_bits: int = DEFAULT_FP_BITS
) -> dict[str, np.ndarray]:
    """Ring sum over clients -> float32 mean. The modular sum re-interpreted
    as int64 is the exact signed fixed-point sum as long as
    ``|sum| < 2^63 / 2^fp_bits`` per element (n_clients * max|w| < 2^39 at
    the default 24 bits — orders of magnitude of headroom)."""
    scale = float(1 << fp_bits)
    out = {}
    for key, arr in summed.items():
        if arr.dtype != np.uint64:
            raise SecureAggError(f"summed tensor {key!r} is {arr.dtype}, expected uint64")
        signed = arr.view(np.int64)
        out[key] = (signed / (scale * n_clients)).astype(np.float32)
    return out


def _pair_stream(
    pair_secret: bytes, session: bytes, round_index: int, lo: int, hi: int
) -> np.random.Generator:
    """The (lo, hi) client pair's shared mask PRG for one round. Both ends
    derive the identical stream from their DH pair secret; nobody without
    one of the pair's private keys can.

    ``session`` is the server run's random nonce (delivered in the round
    advert): it domain-separates mask streams across server restarts, so
    re-running the pipeline with the same pair secret and the same round
    numbers never reuses a stream."""
    if not 0 <= round_index < 2**63:
        raise SecureAggError(f"round_index {round_index} out of range [0, 2^63)")
    digest = hashlib.sha256(
        _DOMAIN + pair_secret + session + struct.pack("<Qqq", round_index, lo, hi)
    ).digest()
    return np.random.Generator(
        np.random.Philox(key=int.from_bytes(digest[:16], "little"))
    )


def _apply_pair_stream(
    out: dict[str, np.ndarray],
    pair_secret: bytes,
    session: bytes,
    round_index: int,
    lo: int,
    hi: int,
    *,
    add: bool,
) -> None:
    """Add (or subtract) the (lo, hi) pair's mask stream into ``out``
    in place, drawing per tensor in sorted-key order from one PRG. The
    SINGLE stream-expansion implementation shared by :func:`mask` and
    :func:`residual_mask_sum` — bit-exact cancellation (and reveal-round
    recovery) depends on both ends expanding identically."""
    rng = _pair_stream(pair_secret, session, round_index, lo, hi)
    for key in sorted(out):
        stream = rng.integers(
            0, 2**64, size=out[key].shape, dtype=np.uint64, endpoint=False
        )
        if add:
            out[key] += stream  # uint64 wraps mod 2^64
        else:
            out[key] -= stream


def mask(
    quantized: Mapping[str, np.ndarray],
    *,
    pair_secrets: Mapping[int, bytes],
    round_index: int,
    client_id: int,
    participants: Sequence[int],
    session: bytes = b"",
) -> dict[str, np.ndarray]:
    """Add this client's pairwise masks: +stream for partners above it,
    -stream for partners below (mod 2^64), per sorted tensor key. Summing
    every participant's masked upload cancels all masks bit-exactly.

    ``pair_secrets`` maps each partner id to THIS client's shared secret
    with that partner (:func:`dh_pair_secret`) — per-pair keys, so this
    client's key material never covers pairs it does not belong to."""
    ids = sorted(set(int(p) for p in participants))
    if int(client_id) not in ids:
        raise SecureAggError(f"client {client_id} not in participants {ids}")
    if len(ids) < 2:
        # A single participant has nobody to pair with; masking would be a
        # no-op that still leaks the raw update — refuse loudly.
        raise SecureAggError("secure aggregation needs >= 2 participants")
    missing = [p for p in ids if p != client_id and p not in pair_secrets]
    if missing:
        raise SecureAggError(
            f"client {client_id} lacks pair secrets for partners {missing}"
        )
    out = {k: np.array(quantized[k], dtype=np.uint64, copy=True) for k in sorted(quantized)}
    for other in ids:
        if other == client_id:
            continue
        lo, hi = min(client_id, other), max(client_id, other)
        _apply_pair_stream(
            out, pair_secrets[other], session, round_index, lo, hi,
            add=client_id == lo,
        )
    return out


def masked_upload(
    flat: Mapping[str, np.ndarray],
    *,
    pair_secrets: Mapping[int, bytes],
    round_index: int,
    client_id: int,
    participants: Sequence[int],
    fp_bits: int = DEFAULT_FP_BITS,
    session: bytes = b"",
) -> dict[str, np.ndarray]:
    """Client-side one-call path: quantize then mask."""
    return mask(
        quantize(flat, fp_bits),
        pair_secrets=pair_secrets,
        round_index=round_index,
        client_id=client_id,
        participants=participants,
        session=session,
    )


# ------------------------------------------------- dropout reveal round
#: Server -> survivor: "these keyed participants never uploaded; disclose
#: your pair secrets with them". REVEAL_MAGIC + u32 n + n x i64 dead ids
#: [+ HMAC tag]. The survivor answers REVEAL_RESP_MAGIC + n x (i64 id +
#: 32-byte pair secret) [+ tag].
PAIR_SECRET_LEN = 32
_TAG_LEN = 32


def _reveal_tag(auth_key: bytes, kind: bytes, session: bytes,
                round_index: int, body: bytes) -> bytes:
    import hmac

    return hmac.new(
        auth_key,
        _DOMAIN + kind + session + struct.pack("<Q", round_index) + body,
        hashlib.sha256,
    ).digest()


def build_reveal_request(
    dead: Sequence[int], *, session: bytes, round_index: int,
    auth_key: bytes | None = None,
) -> bytes:
    ids = sorted(set(int(d) for d in dead))
    body = struct.pack("<I", len(ids)) + b"".join(
        struct.pack("<q", d) for d in ids
    )
    msg = REVEAL_MAGIC + body
    if auth_key is not None:
        msg += _reveal_tag(auth_key, b"-rq", session, round_index, body)
    return msg


def parse_reveal_request(
    frame: bytes, *, session: bytes, round_index: int,
    auth_key: bytes | None = None,
) -> list[int]:
    """Validate + parse a reveal request; raises :class:`SecureAggError`
    on malformed frames or (in auth mode) a bad tag."""
    import hmac

    if not frame.startswith(REVEAL_MAGIC):
        raise SecureAggError("not a reveal request")
    body_end = len(frame) - (_TAG_LEN if auth_key is not None else 0)
    body = frame[len(REVEAL_MAGIC) : body_end]
    if auth_key is not None and not hmac.compare_digest(
        frame[body_end:],
        _reveal_tag(auth_key, b"-rq", session, round_index, body),
    ):
        raise SecureAggError("reveal request failed its authenticity check")
    if len(body) < 4:
        raise SecureAggError("truncated reveal request")
    (n,) = struct.unpack("<I", body[:4])
    if len(body) != 4 + 8 * n or n == 0:
        raise SecureAggError("malformed reveal request body")
    ids = list(struct.unpack(f"<{n}q", body[4:]))
    if len(set(ids)) != n:
        raise SecureAggError("duplicate ids in reveal request")
    return ids


def build_reveal_response(
    secrets: Mapping[int, bytes], *, session: bytes, round_index: int,
    client_id: int, auth_key: bytes | None = None,
) -> bytes:
    body = b"".join(
        struct.pack("<q", d) + secrets[d] for d in sorted(secrets)
    )
    msg = REVEAL_RESP_MAGIC + body
    if auth_key is not None:
        msg += _reveal_tag(
            auth_key, b"-ra" + struct.pack("<q", client_id),
            session, round_index, body,
        )
    return msg


def parse_reveal_response(
    frame: bytes, *, session: bytes, round_index: int, client_id: int,
    expect_dead: Sequence[int], auth_key: bytes | None = None,
) -> dict[int, bytes]:
    import hmac

    if not frame.startswith(REVEAL_RESP_MAGIC):
        raise SecureAggError("not a reveal response")
    body_end = len(frame) - (_TAG_LEN if auth_key is not None else 0)
    body = frame[len(REVEAL_RESP_MAGIC) : body_end]
    if auth_key is not None and not hmac.compare_digest(
        frame[body_end:],
        _reveal_tag(
            auth_key, b"-ra" + struct.pack("<q", client_id),
            session, round_index, body,
        ),
    ):
        raise SecureAggError(
            f"reveal response from client {client_id} failed its "
            "authenticity check"
        )
    entry = 8 + PAIR_SECRET_LEN
    if len(body) % entry:
        raise SecureAggError("malformed reveal response body")
    out: dict[int, bytes] = {}
    for off in range(0, len(body), entry):
        (d,) = struct.unpack("<q", body[off : off + 8])
        out[d] = body[off + 8 : off + entry]
    if sorted(out) != sorted(set(int(x) for x in expect_dead)):
        raise SecureAggError(
            f"reveal response covers {sorted(out)}, expected "
            f"{sorted(expect_dead)}"
        )
    return out


def residual_mask_sum(
    template: Mapping[str, np.ndarray],
    revealed: Mapping[int, Mapping[int, bytes]],  # survivor -> dead -> secret
    *,
    session: bytes,
    round_index: int,
) -> dict[str, np.ndarray]:
    """The uncancelled mask residue a dropout leaves in the ring sum:
    ``sum over survivors i, dead j of sign(i,j) * stream(i,j)`` where
    ``sign`` is + when the survivor is the pair's low id (it ADDED the
    stream in :func:`mask`) and - otherwise. Streams are regenerated in
    the exact draw order ``mask`` used (one PRG per pair, tensors in
    sorted-key order), so subtracting this from the sum restores exact
    modular cancellation over the survivors."""
    out = {
        k: np.zeros_like(np.asarray(template[k], np.uint64))
        for k in sorted(template)
    }
    for survivor, secrets in sorted(revealed.items()):
        for dead_id, secret in sorted(secrets.items()):
            if len(secret) != PAIR_SECRET_LEN:
                raise SecureAggError(
                    f"pair secret for ({survivor}, {dead_id}) has length "
                    f"{len(secret)}"
                )
            lo, hi = min(survivor, dead_id), max(survivor, dead_id)
            _apply_pair_stream(
                out, secret, session, round_index, lo, hi,
                add=survivor == lo,
            )
    return out


def sum_masked(models: Sequence[Mapping[str, np.ndarray]]) -> dict[str, np.ndarray]:
    """Server-side ring sum of masked uploads (mod 2^64). With every
    participant present the pairwise masks cancel exactly."""
    if not models:
        raise SecureAggError("no masked models to sum")
    keys = set(models[0])
    for i, m in enumerate(models[1:], 1):
        if set(m) != keys:
            raise SecureAggError(f"masked model {i} key set differs from model 0")
    out = {}
    for key in keys:
        acc = np.zeros_like(np.asarray(models[0][key], np.uint64))
        for m in models:
            arr = np.asarray(m[key])
            if arr.dtype != np.uint64 or arr.shape != acc.shape:
                raise SecureAggError(
                    f"masked tensor {key!r}: dtype/shape mismatch "
                    f"({arr.dtype}, {arr.shape})"
                )
            acc += arr
        out[key] = acc
    return out


def aggregate_masked(
    models: Sequence[Mapping[str, np.ndarray]],
    fp_bits: int = DEFAULT_FP_BITS,
) -> dict[str, np.ndarray]:
    """Server-side: masked uploads (all participants!) -> float32 mean."""
    return dequantize_sum(sum_masked(models), len(models), fp_bits)


# ---------------------------------------------- double-masking (Bonawitz §6)
# The full construction: every upload additionally carries a SELF-mask
# stream from a per-round seed b_i, and each client Shamir-shares (at
# threshold t) both b_i and the seed of its per-round DH keypair among the
# participants. The unmask round asks survivors for the b-shares of ALIVE
# (contributing) clients and the key-seed shares of DEAD ones; the server
# reconstructs self-masks of contributors and pair masks of the dead, and
# subtracts both from the ring sum. Properties the reveal-round variant
# lacked (comm/secure.py module threat model):
#
# * FALSE-DEATH CLOSURE: an honest holder reveals, per dealer and round,
#   EITHER its b-share (dealer claimed alive) OR its key-seed share
#   (claimed dead), never both. With the default majority threshold
#   t = floor(n/2)+1, assembling t shares of BOTH kinds for one dealer
#   would need more answers than there are holders — so a server that
#   received client j's upload yet declares j dead can reconstruct j's
#   pair masks but NOT j's self-mask: the upload stays hidden.
# * UNMASK-PHASE DROPOUT: reconstruction needs any t holders, so clients
#   may keep dying during the unmask round as long as t survive.
#
# Share blobs travel dealer->server->holder encrypted and MAC'd under the
# (dealer, holder) pair secret — the server relays ciphertext it cannot
# read or undetectably alter.

SEED_LEN = 32
SHARE_BLOB_LEN = 2 * SEED_LEN + 32  # enc(b_share || sk_share) + MAC
#: Protocol selector carried in the round advert: the reveal-round
#: variant (cheaper: no share distribution or unmask round when nobody
#: drops) vs full double-masking (the default).
PROTO_REVEAL = 0
PROTO_DOUBLE = 1


def majority_threshold(n: int) -> int:
    """The default Shamir threshold: a strict majority of the n
    participants. This is what makes the either/or reveal rule binding —
    t-of-both-kinds would need > n answers."""
    return n // 2 + 1


def share_x(client_id: int) -> int:
    """A client's fixed share x-coordinate (ids must stay < 255)."""
    cid = int(client_id)
    if not 0 <= cid < 255:
        raise SecureAggError(
            f"double-masking supports client ids 0..254, got {cid}"
        )
    return cid + 1


def apply_self_stream(
    out: dict[str, np.ndarray],
    seed: bytes,
    session: bytes,
    round_index: int,
    client_id: int,
    *,
    add: bool,
) -> None:
    """Add/subtract client ``client_id``'s self-mask stream (PRG keyed by
    its per-round seed b_i) into ``out`` in place — same sorted-tensor
    draw order as the pair streams, so server-side reconstruction expands
    identically."""
    if len(seed) != SEED_LEN:
        raise SecureAggError(f"self-mask seed has length {len(seed)}")
    digest = hashlib.sha256(
        _DOMAIN + b"-self" + seed + session
        + struct.pack("<Qq", round_index, int(client_id))
    ).digest()
    rng = np.random.Generator(
        np.random.Philox(key=int.from_bytes(digest[:16], "little"))
    )
    for key in sorted(out):
        stream = rng.integers(
            0, 2**64, size=out[key].shape, dtype=np.uint64, endpoint=False
        )
        if add:
            out[key] += stream
        else:
            out[key] -= stream


def self_mask_sum(
    template: Mapping[str, np.ndarray],
    seeds: Mapping[int, bytes],
    *,
    session: bytes,
    round_index: int,
) -> dict[str, np.ndarray]:
    """The summed self-mask streams of the given (client id -> b seed)
    set — what the server subtracts for the round's contributors."""
    out = {
        k: np.zeros_like(np.asarray(template[k], np.uint64))
        for k in sorted(template)
    }
    for cid, seed in sorted(seeds.items()):
        apply_self_stream(out, seed, session, round_index, cid, add=True)
    return out


def _share_keys(
    pair_secret: bytes, session: bytes, round_index: int,
    dealer: int, holder: int,
) -> tuple[bytes, bytes]:
    """(keystream, MAC key) for one share blob, domain-separated from the
    mask streams and bound to (session, round, dealer, holder)."""
    ctx = session + struct.pack("<Qqq", round_index, int(dealer), int(holder))
    stream = hashlib.shake_256(
        _DOMAIN + b"-shenc" + pair_secret + ctx
    ).digest(2 * SEED_LEN)
    mac_key = hashlib.sha256(
        _DOMAIN + b"-shmac" + pair_secret + ctx
    ).digest()
    return stream, mac_key


def encrypt_share_blob(
    pair_secret: bytes,
    session: bytes,
    round_index: int,
    dealer: int,
    holder: int,
    b_share: bytes,
    sk_share: bytes,
) -> bytes:
    """Encrypt-and-MAC one (b-share, key-seed-share) pair for its holder.
    The relaying server sees ciphertext only; tampering fails the MAC at
    the holder."""
    import hmac

    if len(b_share) != SEED_LEN or len(sk_share) != SEED_LEN:
        raise SecureAggError("share blobs carry two 32-byte shares")
    stream, mac_key = _share_keys(
        pair_secret, session, round_index, dealer, holder
    )
    pt = b_share + sk_share
    ct = bytes(a ^ b for a, b in zip(pt, stream))
    return ct + hmac.new(mac_key, ct, hashlib.sha256).digest()


def decrypt_share_blob(
    pair_secret: bytes,
    session: bytes,
    round_index: int,
    dealer: int,
    holder: int,
    blob: bytes,
) -> tuple[bytes, bytes]:
    """Verify + decrypt a relayed share blob -> (b_share, sk_share)."""
    import hmac

    if len(blob) != SHARE_BLOB_LEN:
        raise SecureAggError(f"share blob has length {len(blob)}")
    stream, mac_key = _share_keys(
        pair_secret, session, round_index, dealer, holder
    )
    ct, tag = blob[: 2 * SEED_LEN], blob[2 * SEED_LEN :]
    if not hmac.compare_digest(tag, hmac.new(mac_key, ct, hashlib.sha256).digest()):
        raise SecureAggError(
            f"share blob from dealer {dealer} failed its authenticity "
            "check — possible relay tampering"
        )
    pt = bytes(a ^ b for a, b in zip(ct, stream))
    return pt[:SEED_LEN], pt[SEED_LEN:]


def _unmask_tag(auth_key: bytes, kind: bytes, session: bytes,
                round_index: int, body: bytes) -> bytes:
    import hmac

    return hmac.new(
        auth_key,
        _DOMAIN + kind + session + struct.pack("<Q", round_index) + body,
        hashlib.sha256,
    ).digest()


def build_unmask_request(
    alive: Sequence[int], dead: Sequence[int], *, session: bytes,
    round_index: int, auth_key: bytes | None = None,
) -> bytes:
    """Server -> survivor: 'reveal b-shares for these alive (contributing)
    dealers and key-seed shares for these dead ones'."""
    a = sorted(set(int(x) for x in alive))
    d = sorted(set(int(x) for x in dead))
    body = (
        struct.pack("<I", len(a)) + b"".join(struct.pack("<q", i) for i in a)
        + struct.pack("<I", len(d)) + b"".join(struct.pack("<q", i) for i in d)
    )
    msg = UNMASK_MAGIC + body
    if auth_key is not None:
        msg += _unmask_tag(auth_key, b"-uq", session, round_index, body)
    return msg


def parse_unmask_request(
    frame: bytes, *, session: bytes, round_index: int,
    auth_key: bytes | None = None,
) -> tuple[list[int], list[int]]:
    """Validate + parse -> (alive ids, dead ids). Refuses overlap — an id
    claimed both alive and dead is exactly the both-kinds harvest the
    either/or rule exists to stop."""
    import hmac

    if not frame.startswith(UNMASK_MAGIC):
        raise SecureAggError("not an unmask request")
    body_end = len(frame) - (_TAG_LEN if auth_key is not None else 0)
    body = frame[len(UNMASK_MAGIC) : body_end]
    if auth_key is not None and not hmac.compare_digest(
        frame[body_end:],
        _unmask_tag(auth_key, b"-uq", session, round_index, body),
    ):
        raise SecureAggError("unmask request failed its authenticity check")
    if len(body) < 8:
        raise SecureAggError("truncated unmask request")
    (na,) = struct.unpack("<I", body[:4])
    off = 4 + 8 * na
    if len(body) < off + 4:
        raise SecureAggError("malformed unmask request body")
    alive = list(struct.unpack(f"<{na}q", body[4:off]))
    (nd,) = struct.unpack("<I", body[off : off + 4])
    if len(body) != off + 4 + 8 * nd:
        raise SecureAggError("malformed unmask request body")
    dead = list(struct.unpack(f"<{nd}q", body[off + 4 :]))
    if len(set(alive)) != na or len(set(dead)) != nd:
        raise SecureAggError("duplicate ids in unmask request")
    both = set(alive) & set(dead)
    if both:
        raise SecureAggError(
            f"unmask request claims clients {sorted(both)} both alive and "
            "dead — refusing (both-kinds share harvest)"
        )
    if not alive:
        raise SecureAggError("unmask request with no alive clients")
    return alive, dead


def build_unmask_response(
    b_shares: Mapping[int, bytes],
    sk_shares: Mapping[int, bytes],
    *,
    session: bytes,
    round_index: int,
    client_id: int,
    auth_key: bytes | None = None,
) -> bytes:
    """Survivor -> server: this holder's shares, kind-tagged (0 = b-share
    of an alive dealer, 1 = key-seed share of a dead dealer)."""
    entries = []
    for d in sorted(b_shares):
        entries.append(struct.pack("<qB", int(d), 0) + b_shares[d])
    for d in sorted(sk_shares):
        entries.append(struct.pack("<qB", int(d), 1) + sk_shares[d])
    body = struct.pack("<I", len(entries)) + b"".join(entries)
    msg = UNMASK_RESP_MAGIC + body
    if auth_key is not None:
        msg += _unmask_tag(
            auth_key, b"-ua" + struct.pack("<q", int(client_id)),
            session, round_index, body,
        )
    return msg


def parse_unmask_response(
    frame: bytes, *, session: bytes, round_index: int, client_id: int,
    expect_alive: Sequence[int], expect_dead: Sequence[int],
    auth_key: bytes | None = None,
) -> tuple[dict[int, bytes], dict[int, bytes]]:
    """Validate + parse -> ({alive dealer: b-share}, {dead dealer:
    sk-share}); the covered sets must match the request exactly."""
    import hmac

    if not frame.startswith(UNMASK_RESP_MAGIC):
        raise SecureAggError("not an unmask response")
    body_end = len(frame) - (_TAG_LEN if auth_key is not None else 0)
    body = frame[len(UNMASK_RESP_MAGIC) : body_end]
    if auth_key is not None and not hmac.compare_digest(
        frame[body_end:],
        _unmask_tag(
            auth_key, b"-ua" + struct.pack("<q", int(client_id)),
            session, round_index, body,
        ),
    ):
        raise SecureAggError(
            f"unmask response from client {client_id} failed its "
            "authenticity check"
        )
    if len(body) < 4:
        raise SecureAggError("truncated unmask response")
    (n,) = struct.unpack("<I", body[:4])
    entry = 8 + 1 + SEED_LEN
    if len(body) != 4 + n * entry:
        raise SecureAggError("malformed unmask response body")
    b_shares: dict[int, bytes] = {}
    sk_shares: dict[int, bytes] = {}
    for off in range(4, len(body), entry):
        d, kind = struct.unpack("<qB", body[off : off + 9])
        y = body[off + 9 : off + entry]
        if kind == 0:
            if d in b_shares:
                raise SecureAggError(f"duplicate b-share for dealer {d}")
            b_shares[d] = y
        elif kind == 1:
            if d in sk_shares:
                raise SecureAggError(f"duplicate sk-share for dealer {d}")
            sk_shares[d] = y
        else:
            raise SecureAggError(f"unknown share kind {kind}")
    if sorted(b_shares) != sorted(set(int(x) for x in expect_alive)):
        raise SecureAggError(
            f"unmask response b-shares cover {sorted(b_shares)}, expected "
            f"{sorted(expect_alive)}"
        )
    if sorted(sk_shares) != sorted(set(int(x) for x in expect_dead)):
        raise SecureAggError(
            f"unmask response sk-shares cover {sorted(sk_shares)}, "
            f"expected {sorted(expect_dead)}"
        )
    return b_shares, sk_shares


def b_seed_commitment(
    b_seed: bytes, session: bytes, round_index: int, dealer: int
) -> bytes:
    """Public commitment to a dealer's self-mask seed, carried in its
    SHARES frame: the server verifies the Shamir reconstruction against
    it, so corrupted/inconsistent shares fail loudly instead of silently
    skewing the aggregate. (The key seed needs no extra commitment — its
    reconstruction is verified against the dealer's registered DH public
    key.)"""
    return hashlib.sha256(
        _DOMAIN + b"-bcommit" + b_seed + session
        + struct.pack("<Qq", round_index, int(dealer))
    ).digest()


def build_shares_frame(
    dealer: int,
    commit: bytes,
    blobs: Mapping[int, bytes],
    *,
    threshold: int,
    session: bytes,
    round_index: int,
    auth_key: bytes | None = None,
) -> bytes:
    """Dealer -> server: encrypted (b-share, key-seed-share) blobs for
    every other participant, the b-seed commitment, and the Shamir
    threshold the shares were dealt at (the server validates it against
    its own effective threshold — a mismatch could never reconstruct)."""
    if not 2 <= int(threshold) <= 254:
        raise SecureAggError(f"threshold {threshold} out of range [2, 254]")
    body = struct.pack("<qB", int(dealer), int(threshold)) + commit + struct.pack(
        "<I", len(blobs)
    )
    for holder in sorted(blobs):
        blob = blobs[holder]
        if len(blob) != SHARE_BLOB_LEN:
            raise SecureAggError(f"share blob for holder {holder} malformed")
        body += struct.pack("<q", int(holder)) + blob
    msg = SHARES_MAGIC + body
    if auth_key is not None:
        msg += _unmask_tag(auth_key, b"-sh", session, round_index, body)
    return msg


def parse_shares_frame(
    frame: bytes,
    *,
    session: bytes,
    round_index: int,
    auth_key: bytes | None = None,
) -> tuple[int, int, bytes, dict[int, bytes]]:
    """-> (dealer id, threshold, b-seed commitment, {holder: blob}).
    ``auth_key`` is the DEALER's identity key when per-client keys are
    provisioned (the caller looks it up from the claimed dealer id before
    verifying)."""
    import hmac

    if not frame.startswith(SHARES_MAGIC):
        raise SecureAggError("not a shares frame")
    body_end = len(frame) - (_TAG_LEN if auth_key is not None else 0)
    body = frame[len(SHARES_MAGIC) : body_end]
    if auth_key is not None and not hmac.compare_digest(
        frame[body_end:],
        _unmask_tag(auth_key, b"-sh", session, round_index, body),
    ):
        raise SecureAggError("shares frame failed its authenticity check")
    if len(body) < 9 + 32 + 4:
        raise SecureAggError("truncated shares frame")
    dealer, threshold = struct.unpack("<qB", body[:9])
    commit = body[9:41]
    (n,) = struct.unpack("<I", body[41:45])
    entry = 8 + SHARE_BLOB_LEN
    if len(body) != 45 + n * entry:
        raise SecureAggError("malformed shares frame body")
    blobs: dict[int, bytes] = {}
    for off in range(45, len(body), entry):
        (holder,) = struct.unpack("<q", body[off : off + 8])
        if holder in blobs:
            raise SecureAggError(f"duplicate holder {holder} in shares frame")
        blobs[holder] = body[off + 8 : off + entry]
    return dealer, threshold, commit, blobs


def build_shareset_frame(
    share_set: Sequence[int],
    entries: Mapping[int, bytes],
    *,
    session: bytes,
    round_index: int,
    auth_key: bytes | None = None,
) -> bytes:
    """Server -> holder: the round's share-complete participant set U2
    (the set everyone masks over) plus this holder's encrypted share
    blobs from every other dealer in U2."""
    u2 = sorted(set(int(x) for x in share_set))
    body = struct.pack("<I", len(u2)) + b"".join(
        struct.pack("<q", i) for i in u2
    ) + struct.pack("<I", len(entries))
    for dealer in sorted(entries):
        body += struct.pack("<q", int(dealer)) + entries[dealer]
    msg = SHARESET_MAGIC + body
    if auth_key is not None:
        msg += _unmask_tag(auth_key, b"-ss", session, round_index, body)
    return msg


def parse_shareset_frame(
    frame: bytes,
    *,
    session: bytes,
    round_index: int,
    auth_key: bytes | None = None,
) -> tuple[list[int], dict[int, bytes]]:
    """-> (U2 ids, {dealer: blob for this holder})."""
    import hmac

    if not frame.startswith(SHARESET_MAGIC):
        raise SecureAggError("not a shareset frame")
    body_end = len(frame) - (_TAG_LEN if auth_key is not None else 0)
    body = frame[len(SHARESET_MAGIC) : body_end]
    if auth_key is not None and not hmac.compare_digest(
        frame[body_end:],
        _unmask_tag(auth_key, b"-ss", session, round_index, body),
    ):
        raise SecureAggError("shareset frame failed its authenticity check")
    if len(body) < 4:
        raise SecureAggError("truncated shareset frame")
    (nu,) = struct.unpack("<I", body[:4])
    off = 4 + 8 * nu
    if len(body) < off + 4:
        raise SecureAggError("malformed shareset frame body")
    u2 = list(struct.unpack(f"<{nu}q", body[4:off]))
    if len(set(u2)) != nu:
        raise SecureAggError("duplicate ids in shareset U2")
    (m,) = struct.unpack("<I", body[off : off + 4])
    entry = 8 + SHARE_BLOB_LEN
    if len(body) != off + 4 + m * entry:
        raise SecureAggError("malformed shareset frame body")
    entries: dict[int, bytes] = {}
    for e in range(off + 4, len(body), entry):
        (dealer,) = struct.unpack("<q", body[e : e + 8])
        if dealer in entries:
            raise SecureAggError(f"duplicate dealer {dealer} in shareset")
        entries[dealer] = body[e + 8 : e + entry]
    return u2, entries
