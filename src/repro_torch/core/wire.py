"""Layer 0 — the wire plane's binary message codec.

Every protocol message in :mod:`core.messages` has a registered one-byte
wire tag and a compact binary encoding.  The format is designed for the
command hot path of the paper's Section 8 deployment (batched MultiPaxos
over sockets):

  * **Frames** are length-prefixed and versioned: ``[u32 little-endian
    payload length][payload]`` where a payload is ``[u8 frame version]
    [u8 message tag][fields...]``.  Frames self-delimit on a byte
    stream, so the TCP transport (``core/tcp.py``) reads them with two
    ``readexactly`` calls and no scanning.  The version byte
    (``FRAME_VERSION``) lets a reader replay frames recorded by an older
    codec: ``decode_frame`` dispatches through a per-version decoder
    registry, and an unknown *newer* version fails loud instead of
    misparsing.  The same byte versions the proc plane's on-disk state
    files (``encode_state``/``decode_state``).
  * **Headers are struct-packed**: hot-path messages (Phase2A/Phase2B/
    Chosen/ClientRequest/ClientReply/ReplicaAck) have hand-written
    encoders whose fixed fields pack as varints right behind the tag —
    no per-field type tags.
  * **Varints** everywhere: unsigned LEB128, zigzag for signed ints.
    Rounds ``(r, proposer, s)`` are three varints behind a one-byte
    round tag (``NEG_INF`` is its own tag, matching the paper's ``-1``).
  * **Interned strings**: within one frame, every string (addresses,
    client ids, KV keys) is written once; repeats are one-varint
    back-references.  A ``Configuration``'s acceptor tuple therefore
    costs its addresses once even though they also appear in both
    quorum specs — and a ``Batch`` of 16 replies to one client encodes
    the client address a single time.
  * **Batch is one frame**: ``messages.Batch`` encodes its sub-messages
    back-to-back inside a single frame, sharing the intern table — this
    is what makes hot-path batching cheap on the wire, exactly as in
    the paper's batched deployment.

Free-form payloads (``Command.op``, ``ClientReply.result``) go through a
self-describing value encoder (tags for None/bool/int/float/bytes/str/
tuple/list/dict/set/frozenset plus the protocol's own Round/Noop/Command/
Configuration).  Anything outside that vocabulary falls back to a
pickle-tagged blob so the codec is total; the property tests pin the
protocol vocabulary to the compact path.

``encode``/``decode`` are pure and stateless between frames — any frame
decodes on its own, so dropped/reordered/duplicated frames (the paper's
network model) never corrupt codec state.
"""

from __future__ import annotations

import pickle
import struct
from typing import Any, Callable, Dict, List, Tuple, Type

from . import messages as m
from .quorums import Configuration, QuorumSpec
from .rounds import NEG_INF, Round, _NegInf

__all__ = [
    "encode",
    "decode",
    "frame",
    "unframe",
    "FrameReader",
    "FRAME_VERSION",
    "decode_frame",
    "register_frame_version",
    "encode_value",
    "decode_value",
    "encode_state",
    "decode_state",
    "STATE_VERSION",
    "wire_tag",
    "registered_types",
    "MESSAGE_TYPES",
]

_U32 = struct.Struct("<I")
_F64 = struct.Struct("<d")


# --------------------------------------------------------------------------
# Primitives
# --------------------------------------------------------------------------
def _w_uvarint(out: List[bytes], n: int) -> None:
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(bytes((b | 0x80,)))
        else:
            out.append(bytes((b,)))
            return


def _w_varint(out: List[bytes], n: int) -> None:
    _w_uvarint(out, (n << 1) ^ (n >> 63) if -(1 << 62) <= n < (1 << 62) else _zig_big(n))


def _zig_big(n: int) -> int:  # arbitrary-precision zigzag (cold path)
    return (n << 1) if n >= 0 else ((-n << 1) - 1)


class _Reader:
    """A tiny cursor over one frame's payload + its string intern table."""

    __slots__ = ("buf", "pos", "strings")

    def __init__(self, buf: bytes, pos: int = 0):
        self.buf = buf
        self.pos = pos
        self.strings: List[str] = []

    def u8(self) -> int:
        b = self.buf[self.pos]
        self.pos += 1
        return b

    def uvarint(self) -> int:
        buf, pos, shift, n = self.buf, self.pos, 0, 0
        while True:
            b = buf[pos]
            pos += 1
            n |= (b & 0x7F) << shift
            if not b & 0x80:
                self.pos = pos
                return n
            shift += 7

    def varint(self) -> int:
        n = self.uvarint()
        return (n >> 1) ^ -(n & 1)

    def take(self, k: int) -> bytes:
        b = self.buf[self.pos : self.pos + k]
        self.pos += k
        return b


class _Writer:
    __slots__ = ("out", "strings")

    def __init__(self) -> None:
        self.out: List[bytes] = []
        self.strings: Dict[str, int] = {}

    def bytes_value(self) -> bytes:
        return b"".join(self.out)


def _w_str(w: _Writer, s: str) -> None:
    """Interned string: 0 = literal (len + utf8, gets the next index);
    n > 0 = back-reference to string n-1 of this frame."""
    idx = w.strings.get(s)
    if idx is not None:
        _w_uvarint(w.out, idx + 1)
        return
    w.strings[s] = len(w.strings)
    w.out.append(b"\x00")
    raw = s.encode("utf-8")
    _w_uvarint(w.out, len(raw))
    w.out.append(raw)


def _r_str(r: _Reader) -> str:
    n = r.uvarint()
    if n:
        return r.strings[n - 1]
    s = r.take(r.uvarint()).decode("utf-8")
    r.strings.append(s)
    return s


def _w_bytes(w: _Writer, b: bytes) -> None:
    _w_uvarint(w.out, len(b))
    w.out.append(b)


# Rounds: one tag byte, then (r, proposer, s) as varints.  NEG_INF (the
# paper's -1 round) is its own tag so watermark fields stay one byte, and
# None (a not-yet-leader Heartbeat) gets a tag rather than crashing.
def _w_round(w: _Writer, rnd: Any) -> None:
    if isinstance(rnd, _NegInf):
        w.out.append(b"\x00")
        return
    if rnd is None:
        w.out.append(b"\x02")
        return
    w.out.append(b"\x01")
    _w_varint(w.out, rnd.r)
    _w_varint(w.out, rnd.proposer)
    _w_varint(w.out, rnd.s)


def _r_round(r: _Reader) -> Any:
    t = r.u8()
    if t == 0:
        return NEG_INF
    if t == 2:
        return None
    return Round(r.varint(), r.varint(), r.varint())


def _w_config(w: _Writer, c: Configuration) -> None:
    _w_varint(w.out, c.config_id)
    _w_uvarint(w.out, len(c.acceptors))
    for a in c.acceptors:
        _w_str(w, a)
    _w_quorum(w, c.phase1)
    _w_quorum(w, c.phase2)


def _r_config(r: _Reader) -> Configuration:
    cid = r.varint()
    acceptors = tuple(_r_str(r) for _ in range(r.uvarint()))
    return Configuration(
        config_id=cid, acceptors=acceptors, phase1=_r_quorum(r), phase2=_r_quorum(r)
    )


def _w_quorum(w: _Writer, q: QuorumSpec) -> None:
    _w_uvarint(w.out, len(q.members))
    for a in q.members:
        _w_str(w, a)
    _w_uvarint(w.out, q.threshold)
    _w_uvarint(w.out, len(q.explicit))
    for grp in q.explicit:
        _w_uvarint(w.out, len(grp))
        for a in sorted(grp):
            _w_str(w, a)


def _r_quorum(r: _Reader) -> QuorumSpec:
    members = tuple(_r_str(r) for _ in range(r.uvarint()))
    threshold = r.uvarint()
    explicit = tuple(
        frozenset(_r_str(r) for _ in range(r.uvarint()))
        for _ in range(r.uvarint())
    )
    return QuorumSpec(members=members, threshold=threshold, explicit=explicit)


# --------------------------------------------------------------------------
# Self-describing values (Command.op / ClientReply.result / MMP1B.vv ...)
# --------------------------------------------------------------------------
_V_NONE, _V_TRUE, _V_FALSE, _V_INT, _V_FLOAT = 0, 1, 2, 3, 4
_V_BYTES, _V_STR, _V_TUPLE, _V_LIST, _V_DICT = 5, 6, 7, 8, 9
_V_ROUND, _V_NOOP, _V_COMMAND, _V_CONFIG, _V_SET = 10, 11, 12, 13, 14
_V_FROZENSET, _V_PICKLE = 15, 16


def _w_value(w: _Writer, v: Any) -> None:
    out = w.out
    t = type(v)
    if v is None:
        out.append(b"\x00")
    elif v is True:
        out.append(b"\x01")
    elif v is False:
        out.append(b"\x02")
    elif t is int:
        out.append(b"\x03")
        _w_varint(out, v)
    elif t is float:
        out.append(b"\x04")
        out.append(_F64.pack(v))
    elif t is bytes:
        out.append(b"\x05")
        _w_bytes(w, v)
    elif t is str:
        out.append(b"\x06")
        _w_str(w, v)
    elif t is tuple:
        out.append(b"\x07")
        _w_uvarint(out, len(v))
        for x in v:
            _w_value(w, x)
    elif t is list:
        out.append(b"\x08")
        _w_uvarint(out, len(v))
        for x in v:
            _w_value(w, x)
    elif t is dict:
        out.append(b"\x09")
        _w_uvarint(out, len(v))
        for k, x in v.items():
            _w_value(w, k)
            _w_value(w, x)
    elif t is Round or t is _NegInf:
        out.append(b"\x0a")
        _w_round(w, v)
    elif t is m.Noop:
        out.append(b"\x0b")
    elif t is m.Command:
        out.append(b"\x0c")
        _w_cmd(w, v)
    elif t is Configuration:
        out.append(b"\x0d")
        _w_config(w, v)
    elif t is set:
        out.append(b"\x0e")
        _w_uvarint(out, len(v))
        for x in sorted(v, key=repr):
            _w_value(w, x)
    elif t is frozenset:
        out.append(b"\x0f")
        _w_uvarint(out, len(v))
        for x in sorted(v, key=repr):
            _w_value(w, x)
    else:
        # Total-codec fallback: exotic payloads survive, at pickle cost.
        out.append(b"\x10")
        _w_bytes(w, pickle.dumps(v, protocol=pickle.HIGHEST_PROTOCOL))


def _r_value(r: _Reader) -> Any:
    t = r.u8()
    if t == _V_NONE:
        return None
    if t == _V_TRUE:
        return True
    if t == _V_FALSE:
        return False
    if t == _V_INT:
        return r.varint()
    if t == _V_FLOAT:
        return _F64.unpack(r.take(8))[0]
    if t == _V_BYTES:
        return r.take(r.uvarint())
    if t == _V_STR:
        return _r_str(r)
    if t == _V_TUPLE:
        return tuple(_r_value(r) for _ in range(r.uvarint()))
    if t == _V_LIST:
        return [_r_value(r) for _ in range(r.uvarint())]
    if t == _V_DICT:
        return {_r_value(r): _r_value(r) for _ in range(r.uvarint())}
    if t == _V_ROUND:
        return _r_round(r)
    if t == _V_NOOP:
        return m.NOOP
    if t == _V_COMMAND:
        return _r_cmd(r)
    if t == _V_CONFIG:
        return _r_config(r)
    if t == _V_SET:
        return {_r_value(r) for _ in range(r.uvarint())}
    if t == _V_FROZENSET:
        return frozenset(_r_value(r) for _ in range(r.uvarint()))
    if t == _V_PICKLE:
        return pickle.loads(r.take(r.uvarint()))
    raise ValueError(f"unknown value tag {t}")


def _w_cmd(w: _Writer, c: m.Command) -> None:
    _w_str(w, c.cmd_id[0])
    _w_varint(w.out, c.cmd_id[1])
    _w_value(w, c.op)


def _r_cmd(r: _Reader) -> m.Command:
    return m.Command(cmd_id=(_r_str(r), r.varint()), op=_r_value(r))


def _w_history(
    w: _Writer, hist: Tuple[Tuple[Round, Configuration], ...]
) -> None:
    _w_uvarint(w.out, len(hist))
    for rnd, cfg in hist:
        _w_round(w, rnd)
        _w_config(w, cfg)


def _r_history(r: _Reader) -> Tuple[Tuple[Round, Configuration], ...]:
    return tuple((_r_round(r), _r_config(r)) for _ in range(r.uvarint()))


def _w_shard_logs(w: _Writer, logs: Tuple[m.ShardLogSnapshot, ...]) -> None:
    _w_uvarint(w.out, len(logs))
    for shard, entries, gc_w in logs:
        _w_uvarint(w.out, shard)
        _w_history(w, entries)
        _w_round(w, gc_w)


def _r_shard_logs(r: _Reader) -> Tuple[m.ShardLogSnapshot, ...]:
    return tuple(
        (r.uvarint(), _r_history(r), _r_round(r)) for _ in range(r.uvarint())
    )


# --------------------------------------------------------------------------
# The tag registry: every message type in core/messages.py
# --------------------------------------------------------------------------
_ENCODERS: Dict[type, Tuple[int, Callable[[_Writer, Any], None]]] = {}
_DECODERS: Dict[int, Callable[[_Reader], Any]] = {}


def _register(
    tag: int,
    cls: type,
    enc: Callable[[_Writer, Any], None],
    dec: Callable[[_Reader], Any],
) -> None:
    assert tag not in _DECODERS, f"duplicate wire tag {tag}"
    assert cls not in _ENCODERS, f"duplicate codec for {cls.__name__}"
    _ENCODERS[cls] = (tag, enc)
    _DECODERS[tag] = dec


# -- hot path (struct-packed headers: tag, then raw varint fields) ---------
_register(
    1,
    m.ClientRequest,
    lambda w, x: _w_cmd(w, x.command),
    lambda r: m.ClientRequest(command=_r_cmd(r)),
)


def _enc_client_reply(w: _Writer, x: m.ClientReply) -> None:
    _w_str(w, x.cmd_id[0])
    _w_varint(w.out, x.cmd_id[1])
    _w_varint(w.out, -1 if x.slot is None else x.slot)
    _w_value(w, x.result)


def _dec_client_reply(r: _Reader) -> m.ClientReply:
    cmd_id = (_r_str(r), r.varint())
    slot = r.varint()
    return m.ClientReply(
        cmd_id=cmd_id, result=_r_value(r), slot=None if slot < 0 else slot
    )


_register(2, m.ClientReply, _enc_client_reply, _dec_client_reply)


def _enc_phase2a(w: _Writer, x: m.Phase2A) -> None:
    _w_round(w, x.round)
    _w_varint(w.out, x.slot)
    _w_value(w, x.value)


_register(
    3,
    m.Phase2A,
    _enc_phase2a,
    lambda r: m.Phase2A(round=_r_round(r), slot=r.varint(), value=_r_value(r)),
)


def _enc_phase2b(w: _Writer, x: m.Phase2B) -> None:
    _w_round(w, x.round)
    _w_varint(w.out, x.slot)


_register(
    4,
    m.Phase2B,
    _enc_phase2b,
    lambda r: m.Phase2B(round=_r_round(r), slot=r.varint()),
)


def _enc_chosen(w: _Writer, x: m.Chosen) -> None:
    _w_varint(w.out, x.slot)
    _w_value(w, x.value)


_register(
    5,
    m.Chosen,
    _enc_chosen,
    lambda r: m.Chosen(slot=r.varint(), value=_r_value(r)),
)
_register(
    6,
    m.ReplicaAck,
    lambda w, x: _w_varint(w.out, x.watermark),
    lambda r: m.ReplicaAck(watermark=r.varint()),
)


# Varint-delta slot runs (ROADMAP wire-plane follow-on): inside a Batch,
# consecutive Phase2B messages sharing one round — the dominant ack shape
# of the batched hot path — collapse to a single run header plus zigzag
# slot deltas, and consecutive Chosen messages share one run header with
# per-entry (delta, value) pairs.  Runs exist only inside Batch payloads;
# top-level frames never emit these tags.
_TAG_P2B_RUN = 41
_TAG_CHOSEN_RUN = 42
_RUN_MIN = 2  # a run of two already beats two full headers


def _batch_groups(msgs: Tuple[Any, ...]) -> List[Any]:
    """Partition a batch's messages into encodable items: single messages,
    ``("p2b", round, [slots])`` runs and ``("chosen", [(slot, value)])``
    runs.  Grouping only ever merges *consecutive* messages, so decoding
    reproduces the original order exactly."""
    groups: List[Any] = []
    i, n = 0, len(msgs)
    while i < n:
        msg = msgs[i]
        t = type(msg)
        if t is m.Phase2B:
            j = i + 1
            while j < n and type(msgs[j]) is m.Phase2B and msgs[j].round == msg.round:
                j += 1
            if j - i >= _RUN_MIN:
                groups.append(("p2b", msg.round, [x.slot for x in msgs[i:j]]))
                i = j
                continue
        elif t is m.Chosen:
            j = i + 1
            while j < n and type(msgs[j]) is m.Chosen:
                j += 1
            if j - i >= _RUN_MIN:
                groups.append(("chosen", [(x.slot, x.value) for x in msgs[i:j]]))
                i = j
                continue
        groups.append(msg)
        i += 1
    return groups


def _enc_batch(w: _Writer, x: m.Batch) -> None:
    groups = _batch_groups(x.messages)
    _w_uvarint(w.out, len(groups))
    for g in groups:
        if type(g) is tuple and g[0] == "p2b":
            _, rnd, slots = g
            w.out.append(bytes((_TAG_P2B_RUN,)))
            _w_round(w, rnd)
            _w_uvarint(w.out, len(slots))
            _w_varint(w.out, slots[0])
            for k in range(1, len(slots)):
                _w_varint(w.out, slots[k] - slots[k - 1])
        elif type(g) is tuple and g[0] == "chosen":
            _, entries = g
            w.out.append(bytes((_TAG_CHOSEN_RUN,)))
            _w_uvarint(w.out, len(entries))
            prev = entries[0][0]
            _w_varint(w.out, prev)
            _w_value(w, entries[0][1])
            for slot, value in entries[1:]:
                _w_varint(w.out, slot - prev)
                _w_value(w, value)
                prev = slot
        else:
            tag, enc = _ENCODERS[type(g)]
            w.out.append(bytes((tag,)))
            enc(w, g)


def _dec_batch(r: _Reader) -> Tuple[Any, ...]:
    out: List[Any] = []
    for _ in range(r.uvarint()):
        tag = r.u8()
        if tag == _TAG_P2B_RUN:
            rnd = _r_round(r)
            count = r.uvarint()
            slot = r.varint()
            out.append(m.Phase2B(round=rnd, slot=slot))
            for _k in range(count - 1):
                slot += r.varint()
                out.append(m.Phase2B(round=rnd, slot=slot))
        elif tag == _TAG_CHOSEN_RUN:
            count = r.uvarint()
            slot = r.varint()
            out.append(m.Chosen(slot=slot, value=_r_value(r)))
            for _k in range(count - 1):
                slot += r.varint()
                out.append(m.Chosen(slot=slot, value=_r_value(r)))
        else:
            out.append(_DECODERS[tag](r))
    return tuple(out)


_register(7, m.Batch, _enc_batch, lambda r: m.Batch(messages=_dec_batch(r)))


# -- SealedBatch: the relay-safe envelope (zero-copy router fast path) ------
# Payload: [uvarint count] then per sub-message [uvarint len][tag][fields].
# Unlike Batch, every sub-frame carries its OWN intern table (a fresh
# _Writer per sub-message), so any subset of the encoded sub-frames is
# itself a valid sequence of sub-frames: a relay forwards by slicing the
# received bytes, and intern back-references can never dangle across a
# split.  The price is re-interning shared strings per sub-message; the
# win is that a router hop costs O(bytes moved), not O(decode + encode).
def _enc_sealed(w: _Writer, x: "m.SealedBatch") -> None:
    raw, spans = x.raw, x.spans
    if raw is not None and spans is not None:
        # Relay fast path: the sub-frames are already encoded (each is
        # self-contained); re-emit the byte ranges verbatim.
        _w_uvarint(w.out, len(spans))
        for s, e in spans:
            _w_uvarint(w.out, e - s)
            w.out.append(raw[s:e])
        return
    msgs = x.messages
    _w_uvarint(w.out, len(msgs))
    for msg in msgs:
        sub = encode(msg)  # fresh writer: self-contained intern scope
        _w_uvarint(w.out, len(sub))
        w.out.append(sub)


def _dec_sealed(r: _Reader) -> "m.SealedBatch":
    # Record sub-frame byte ranges WITHOUT decoding them — the lazy
    # ``SealedBatch.messages`` property decodes on first access, so a
    # relay hop (decode frame -> regroup spans -> re-frame) never touches
    # the command bodies.
    n = r.uvarint()
    spans = []
    for _ in range(n):
        k = r.uvarint()
        spans.append((r.pos, r.pos + k))
        r.pos += k
    return m.SealedBatch(raw=r.buf, spans=tuple(spans))


_register(44, m.SealedBatch, _enc_sealed, _dec_sealed)


def sealed_messages(
    raw: bytes, spans: Tuple[Tuple[int, int], ...]
) -> Tuple[Any, ...]:
    """Decode a SealedBatch's sub-frames (each one self-contained)."""
    return tuple(_decode_at(raw, s) for s, _e in spans)


def _decode_at(buf: bytes, pos: int) -> Any:
    """Decode one [tag][fields] sub-frame starting at ``pos`` in ``buf``
    (a fresh intern scope, exactly like a top-level payload)."""
    r = _Reader(buf, pos)
    tag = r.u8()
    if tag == _TAG_PICKLE:
        return pickle.loads(r.take(r.uvarint()))
    dec = _DECODERS.get(tag)
    if dec is None:
        raise ValueError(f"unknown wire tag {tag}")
    return dec(r)


def peek_request_cmd_id(
    raw: bytes, span: Tuple[int, int]
) -> Tuple[str, int] | None:
    """Read the ``cmd_id`` of a ClientRequest sub-frame without decoding
    the command body (the router's shard hash needs only the id).  Returns
    None when the sub-frame is not a ClientRequest — the relay falls back
    to full decode for those.

    Safe on a self-contained sub-frame only: the leading client-address
    string is by construction a literal there (fresh intern table), never
    a back-reference into another sub-message."""
    s, _e = span
    if raw[s] != _TAG_CLIENT_REQUEST:
        return None
    r = _Reader(raw, s + 1)
    client = _r_str(r)  # first string of the sub-frame: always a literal
    return (client, r.varint())


_TAG_CLIENT_REQUEST = 1  # must match the ClientRequest registration above

# -- matchmaking (Algorithms 1 and 4) --------------------------------------


def _enc_match_a(w: _Writer, x: m.MatchA) -> None:
    _w_round(w, x.round)
    _w_config(w, x.config)
    _w_uvarint(w.out, x.shard)


_register(
    8,
    m.MatchA,
    _enc_match_a,
    lambda r: m.MatchA(round=_r_round(r), config=_r_config(r), shard=r.uvarint()),
)


def _enc_match_b(w: _Writer, x: m.MatchB) -> None:
    _w_round(w, x.round)
    _w_round(w, x.gc_watermark)
    _w_history(w, x.history)


_register(
    9,
    m.MatchB,
    _enc_match_b,
    lambda r: m.MatchB(
        round=_r_round(r), gc_watermark=_r_round(r), history=_r_history(r)
    ),
)


def _enc_match_nack(w: _Writer, x: m.MatchNack) -> None:
    _w_round(w, x.round)
    _w_round(w, x.witnessed)


_register(
    10,
    m.MatchNack,
    _enc_match_nack,
    lambda r: m.MatchNack(round=_r_round(r), witnessed=_r_round(r)),
)

# -- phase 1 ----------------------------------------------------------------


def _enc_phase1a(w: _Writer, x: m.Phase1A) -> None:
    _w_round(w, x.round)
    _w_varint(w.out, x.from_slot)


_register(
    11,
    m.Phase1A,
    _enc_phase1a,
    lambda r: m.Phase1A(round=_r_round(r), from_slot=r.varint()),
)


def _enc_phase1b(w: _Writer, x: m.Phase1B) -> None:
    _w_round(w, x.round)
    _w_varint(w.out, x.chosen_watermark)
    _w_uvarint(w.out, len(x.votes))
    for v in x.votes:
        _w_varint(w.out, v.slot)
        _w_round(w, v.vr)
        _w_value(w, v.vv)


def _dec_phase1b(r: _Reader) -> m.Phase1B:
    rnd = _r_round(r)
    wmark = r.varint()
    votes = tuple(
        m.PhaseVote(slot=r.varint(), vr=_r_round(r), vv=_r_value(r))
        for _ in range(r.uvarint())
    )
    return m.Phase1B(round=rnd, votes=votes, chosen_watermark=wmark)


_register(12, m.Phase1B, _enc_phase1b, _dec_phase1b)


def _enc_phase1nack(w: _Writer, x: m.Phase1Nack) -> None:
    _w_round(w, x.round)
    _w_round(w, x.witnessed)


_register(
    13,
    m.Phase1Nack,
    _enc_phase1nack,
    lambda r: m.Phase1Nack(round=_r_round(r), witnessed=_r_round(r)),
)


def _enc_phase2nack(w: _Writer, x: m.Phase2Nack) -> None:
    _w_round(w, x.round)
    _w_varint(w.out, x.slot)
    _w_round(w, x.witnessed)


_register(
    14,
    m.Phase2Nack,
    _enc_phase2nack,
    lambda r: m.Phase2Nack(round=_r_round(r), slot=r.varint(), witnessed=_r_round(r)),
)


def _enc_vote_standalone(w: _Writer, x: m.PhaseVote) -> None:
    _w_varint(w.out, x.slot)
    _w_round(w, x.vr)
    _w_value(w, x.vv)


_register(
    15,
    m.PhaseVote,
    _enc_vote_standalone,
    lambda r: m.PhaseVote(slot=r.varint(), vr=_r_round(r), vv=_r_value(r)),
)

# -- replication / recovery -------------------------------------------------


def _enc_stored(w: _Writer, x: m.StoredWatermark) -> None:
    _w_round(w, x.round)
    _w_varint(w.out, x.watermark)


_register(
    16,
    m.StoredWatermark,
    _enc_stored,
    lambda r: m.StoredWatermark(round=_r_round(r), watermark=r.varint()),
)


def _enc_stored_ack(w: _Writer, x: m.StoredWatermarkAck) -> None:
    _w_round(w, x.round)
    _w_varint(w.out, x.watermark)


_register(
    17,
    m.StoredWatermarkAck,
    _enc_stored_ack,
    lambda r: m.StoredWatermarkAck(round=_r_round(r), watermark=r.varint()),
)
_register(
    18,
    m.FillRequest,
    lambda w, x: _w_varint(w.out, x.slot),
    lambda r: m.FillRequest(slot=r.varint()),
)
_register(19, m.RecoverA, lambda w, x: None, lambda r: m.RecoverA())


def _enc_recover_b(w: _Writer, x: m.RecoverB) -> None:
    _w_varint(w.out, x.watermark)
    _w_uvarint(w.out, len(x.entries))
    for slot, val in x.entries:
        _w_varint(w.out, slot)
        _w_value(w, val)


def _dec_recover_b(r: _Reader) -> m.RecoverB:
    wmark = r.varint()
    entries = tuple((r.varint(), _r_value(r)) for _ in range(r.uvarint()))
    return m.RecoverB(watermark=wmark, entries=entries)


_register(20, m.RecoverB, _enc_recover_b, _dec_recover_b)

# -- garbage collection (Section 5) ----------------------------------------


def _enc_garbage_a(w: _Writer, x: m.GarbageA) -> None:
    _w_round(w, x.round)
    _w_uvarint(w.out, x.shard)


_register(
    21,
    m.GarbageA,
    _enc_garbage_a,
    lambda r: m.GarbageA(round=_r_round(r), shard=r.uvarint()),
)
_register(
    22,
    m.GarbageB,
    lambda w, x: _w_round(w, x.round),
    lambda r: m.GarbageB(round=_r_round(r)),
)

# -- matchmaker reconfiguration (Section 6) --------------------------------
_register(23, m.StopA, lambda w, x: None, lambda r: m.StopA())


def _enc_stop_b(w: _Writer, x: m.StopB) -> None:
    _w_history(w, x.log)
    _w_round(w, x.gc_watermark)
    _w_shard_logs(w, x.shard_logs)


_register(
    24,
    m.StopB,
    _enc_stop_b,
    lambda r: m.StopB(
        log=_r_history(r), gc_watermark=_r_round(r), shard_logs=_r_shard_logs(r)
    ),
)


def _enc_bootstrap(w: _Writer, x: m.Bootstrap) -> None:
    _w_history(w, x.log)
    _w_round(w, x.gc_watermark)
    _w_shard_logs(w, x.shard_logs)


_register(
    25,
    m.Bootstrap,
    _enc_bootstrap,
    lambda r: m.Bootstrap(
        log=_r_history(r), gc_watermark=_r_round(r), shard_logs=_r_shard_logs(r)
    ),
)
_register(26, m.BootstrapAck, lambda w, x: None, lambda r: m.BootstrapAck())
_register(27, m.MMEnable, lambda w, x: None, lambda r: m.MMEnable())
_register(
    28,
    m.MMP1A,
    lambda w, x: _w_round(w, x.ballot),
    lambda r: m.MMP1A(ballot=_r_round(r)),
)


def _enc_mmp1b(w: _Writer, x: m.MMP1B) -> None:
    _w_round(w, x.ballot)
    _w_round(w, x.vb)
    _w_value(w, x.vv)


_register(
    29,
    m.MMP1B,
    _enc_mmp1b,
    lambda r: m.MMP1B(ballot=_r_round(r), vb=_r_round(r), vv=_r_value(r)),
)


def _enc_mmp2a(w: _Writer, x: m.MMP2A) -> None:
    _w_round(w, x.ballot)
    _w_uvarint(w.out, len(x.value))
    for a in x.value:
        _w_str(w, a)


def _dec_mmp2a(r: _Reader) -> m.MMP2A:
    ballot = _r_round(r)
    value = tuple(_r_str(r) for _ in range(r.uvarint()))
    return m.MMP2A(ballot=ballot, value=value)


_register(30, m.MMP2A, _enc_mmp2a, _dec_mmp2a)
_register(
    31,
    m.MMP2B,
    lambda w, x: _w_round(w, x.ballot),
    lambda r: m.MMP2B(ballot=_r_round(r)),
)
_register(
    32,
    m.MMNack,
    lambda w, x: _w_round(w, x.ballot),
    lambda r: m.MMNack(ballot=_r_round(r)),
)

# -- leader election / failure detection -----------------------------------
_register(
    33,
    m.LeaderHint,
    lambda w, x: _w_str(w, x.leader),
    lambda r: m.LeaderHint(leader=_r_str(r)),
)
_register(
    34,
    m.Heartbeat,
    lambda w, x: _w_round(w, x.round),
    lambda r: m.Heartbeat(round=_r_round(r)),
)
_register(
    35,
    m.Ping,
    lambda w, x: _w_varint(w.out, x.nonce),
    lambda r: m.Ping(nonce=r.varint()),
)
_register(
    36,
    m.Pong,
    lambda w, x: _w_varint(w.out, x.nonce),
    lambda r: m.Pong(nonce=r.varint()),
)

# -- Fast Paxos (Section 7) -------------------------------------------------


def _enc_fast_p2a(w: _Writer, x: m.FastP2A) -> None:
    _w_round(w, x.round)
    _w_value(w, x.value)


_register(
    37,
    m.FastP2A,
    _enc_fast_p2a,
    lambda r: m.FastP2A(round=_r_round(r), value=_r_value(r)),
)


def _enc_fast_p2b(w: _Writer, x: m.FastP2B) -> None:
    _w_round(w, x.round)
    _w_value(w, x.value)


_register(
    38,
    m.FastP2B,
    _enc_fast_p2b,
    lambda r: m.FastP2B(round=_r_round(r), value=_r_value(r)),
)

# -- values that travel bare (Command retransmissions in tests) ------------
_register(39, m.Command, _w_cmd, _r_cmd)
_register(40, m.Noop, lambda w, x: None, lambda r: m.NOOP)

# Tags 41/42 are reserved for the in-batch Phase2B/Chosen run encodings
# above; they never appear at the top level of a frame.


def _enc_set_matchmakers(w: _Writer, x: m.SetMatchmakers) -> None:
    _w_uvarint(w.out, len(x.matchmakers))
    for a in x.matchmakers:
        _w_str(w, a)


_register(
    43,
    m.SetMatchmakers,
    _enc_set_matchmakers,
    lambda r: m.SetMatchmakers(
        matchmakers=tuple(_r_str(r) for _ in range(r.uvarint()))
    ),
)

# Escape hatch so the codec is total over *any* message object (e.g. the
# horizontal baseline's ConfigChange riding inside Chosen values is
# covered by the value encoder; a whole unknown message type pickles).
_TAG_PICKLE = 255


# --------------------------------------------------------------------------
# Public API
# --------------------------------------------------------------------------
def registered_types() -> Tuple[type, ...]:
    return tuple(_ENCODERS)


def wire_tag(cls: Type[Any]) -> int:
    return _ENCODERS[cls][0]


def encode(msg: Any) -> bytes:
    """One frame payload: [u8 tag][fields].  No length prefix."""
    w = _Writer()
    entry = _ENCODERS.get(type(msg))
    if entry is None:
        w.out.append(bytes((_TAG_PICKLE,)))
        _w_bytes(w, pickle.dumps(msg, protocol=pickle.HIGHEST_PROTOCOL))
        return w.bytes_value()
    tag, enc = entry
    w.out.append(bytes((tag,)))
    enc(w, msg)
    return w.bytes_value()


def decode(payload: bytes) -> Any:
    r = _Reader(payload)
    tag = r.u8()
    if tag == _TAG_PICKLE:
        return pickle.loads(r.take(r.uvarint()))
    dec = _DECODERS.get(tag)
    if dec is None:
        raise ValueError(f"unknown wire tag {tag}")
    return dec(r)


# -- frame versioning -------------------------------------------------------
# The first payload byte of every frame is the codec version.  Decoding
# dispatches through a per-version registry so a newer reader can replay
# frames (or on-disk state files) recorded by an older codec, and an
# unknown *newer* version fails loud instead of misparsing.  Version 1 is
# the current encoding (everything in this module).
FRAME_VERSION = 1
_FRAME_DECODERS: Dict[int, Callable[[bytes], Any]] = {FRAME_VERSION: decode}


def register_frame_version(version: int, dec: Callable[[bytes], Any]) -> None:
    """Register a payload decoder for an older (or experimental) frame
    version.  ``dec`` receives the payload *without* the version byte."""
    _FRAME_DECODERS[version] = dec


def decode_frame(payload: bytes) -> Any:
    """Decode one versioned frame payload: [u8 version][tag][fields]."""
    version = payload[0]
    dec = _FRAME_DECODERS.get(version)
    if dec is None:
        raise ValueError(
            f"unsupported frame version {version} "
            f"(this codec speaks {sorted(_FRAME_DECODERS)})"
        )
    return dec(payload[1:])


def frame(msg: Any) -> bytes:
    """A full wire frame: [u32 LE payload length][u8 version][payload]."""
    payload = encode(msg)
    return _U32.pack(len(payload) + 1) + bytes((FRAME_VERSION,)) + payload


def unframe(buf: bytes) -> Tuple[Any, int]:
    """Decode the first frame of ``buf``; returns (message, bytes consumed)."""
    (n,) = _U32.unpack_from(buf)
    end = 4 + n
    return decode_frame(buf[4:end]), end


class FrameReader:
    """Incremental frame splitter for a byte stream (tests; the TCP
    transport itself uses ``readexactly`` and never buffers)."""

    __slots__ = ("_buf",)

    def __init__(self) -> None:
        self._buf = bytearray()

    def feed(self, data: bytes) -> List[Any]:
        self._buf.extend(data)
        msgs: List[Any] = []
        while len(self._buf) >= 4:
            (n,) = _U32.unpack_from(self._buf)
            if len(self._buf) < 4 + n:
                break
            msgs.append(decode_frame(bytes(self._buf[4 : 4 + n])))
            del self._buf[: 4 + n]
        return msgs


# -- free-standing values and on-disk state ---------------------------------
def encode_value(v: Any) -> bytes:
    """Encode one value through the self-describing value codec."""
    w = _Writer()
    _w_value(w, v)
    return w.bytes_value()


def decode_value(data: bytes) -> Any:
    return _r_value(_Reader(data))


# -- canonical fingerprint encoding (the verification plane, core/mc.py) ----
_V_WIREMSG = 0x11  # encode-only: a registered wire message, embedded by bytes


def encode_canonical(v: Any) -> bytes:
    """Canonical value encoding for model-checker state fingerprints.

    Like :func:`encode_value` but with all ordering history erased: dict
    items are written sorted by the canonical encoding of their key
    (``_w_value`` keeps insertion order, so two runs that built the same
    mapping in different orders would otherwise hash apart), sets and
    frozensets are sorted the same way (``_w_value`` sorts by ``repr``,
    which is stable but not canonical for nested containers), and any
    registered wire message embeds as its :func:`encode` bytes.  This is
    encode-only — tag ``0x11`` has no reader; fingerprints are hashed,
    never decoded.
    """
    w = _Writer()
    _w_canon(w, v)
    return w.bytes_value()


def _canon_sort_key(v: Any) -> bytes:
    # A fresh writer per key: no interning shared with the enclosing
    # frame, so the sort key is a self-contained byte string.
    w = _Writer()
    _w_canon(w, v)
    return w.bytes_value()


def _w_canon(w: _Writer, v: Any) -> None:
    t = type(v)
    if t is dict:
        w.out.append(bytes((_V_DICT,)))
        _w_uvarint(w.out, len(v))
        for _, k, x in sorted(
            ((_canon_sort_key(k), k, x) for k, x in v.items()),
            key=lambda e: e[0],
        ):
            _w_canon(w, k)
            _w_canon(w, x)
    elif t is set or t is frozenset:
        w.out.append(bytes((_V_SET if t is set else _V_FROZENSET,)))
        _w_uvarint(w.out, len(v))
        for x in sorted(v, key=_canon_sort_key):
            _w_canon(w, x)
    elif t is tuple or t is list:
        w.out.append(bytes((_V_TUPLE if t is tuple else _V_LIST,)))
        _w_uvarint(w.out, len(v))
        for x in v:
            _w_canon(w, x)
    elif t in _ENCODERS:
        w.out.append(bytes((_V_WIREMSG,)))
        _w_bytes(w, encode(v))
    else:
        _w_value(w, v)


# On-disk node state (the proc plane's per-node state files).  Same
# version byte as the wire: [magic "MP"][u8 version][value-encoded obj].
_STATE_MAGIC = b"MP"
STATE_VERSION = FRAME_VERSION
_STATE_DECODERS: Dict[int, Callable[[bytes], Any]] = {STATE_VERSION: decode_value}


def encode_state(obj: Any) -> bytes:
    return _STATE_MAGIC + bytes((STATE_VERSION,)) + encode_value(obj)


def decode_state(data: bytes) -> Any:
    if data[:2] != _STATE_MAGIC:
        raise ValueError("not a state file (bad magic)")
    version = data[2]
    dec = _STATE_DECODERS.get(version)
    if dec is None:
        raise ValueError(
            f"unsupported state version {version} "
            f"(this codec speaks {sorted(_STATE_DECODERS)})"
        )
    return dec(data[3:])


# Every public message dataclass in core/messages.py, discovered by
# inspection — the property tests assert all of them have a codec.
import dataclasses as _dc  # noqa: E402

MESSAGE_TYPES: Tuple[type, ...] = tuple(
    obj
    for name, obj in vars(m).items()
    if isinstance(obj, type)
    and _dc.is_dataclass(obj)
    and obj.__module__ == m.__name__
    and not name.startswith("_")
)
