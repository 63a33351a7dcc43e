"""Snappy framed-stream (.sz) codec.

The reference stores every intermediate and prepared file as a snappy
*framed* stream (golang/snappy NewReader/NewBufferedWriter; see e.g.
/root/reference/cmd/muscato_prep_targets/main.go:296-316).  muscato_tpu keeps
its working set in arrays, but must still read reference-prepared inputs
(tests/data/prep_targets/06-07 ship real snappy-compressed genes.txt.sz) and
write .sz prepared-target outputs for drop-in compatibility.

This module implements the framing format and the snappy block format:

  stream   = ident chunk, then data chunks
  ident    = 0xff 0x06 0x00 0x00 "sNaPpY"
  chunk    = type:1  len:3(LE)  payload
  type 0x00 = compressed:   crc32c(masked, LE, of the UNCOMPRESSED data) + block
  type 0x01 = uncompressed: crc32c(masked, LE) + raw bytes
  max uncompressed payload per chunk = 65536

Block format: varint uncompressed-length, then literal/copy tags.

A native C++ fast path (muscato_tpu.io.native) is used when available; the
pure-Python path here is the always-available fallback and the reference
implementation for tests.
"""

from __future__ import annotations

import struct

_IDENT = b"\xff\x06\x00\x00sNaPpY"
_MAX_CHUNK = 65536

# ---------------------------------------------------------------- crc32c ---

_CRC32C_POLY = 0x82F63B78
_crc_table = None


def _get_crc_table():
    global _crc_table
    if _crc_table is None:
        tab = []
        for n in range(256):
            c = n
            for _ in range(8):
                c = (c >> 1) ^ (_CRC32C_POLY if c & 1 else 0)
            tab.append(c)
        _crc_table = tab
    return _crc_table


def crc32c(data: bytes, crc: int = 0) -> int:
    tab = _get_crc_table()
    c = crc ^ 0xFFFFFFFF
    for b in data:
        c = tab[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ------------------------------------------------------------ block codec ---


def _read_varint(buf: bytes, pos: int):
    shift = 0
    out = 0
    while True:
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7


def _write_varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def block_decompress(buf: bytes) -> bytes:
    """Decompress one snappy block."""
    n, pos = _read_varint(buf, 0)
    out = bytearray()
    ln = len(buf)
    while pos < ln:
        tag = buf[pos]
        pos += 1
        kind = tag & 3
        if kind == 0:  # literal
            length = tag >> 2
            if length < 60:
                length += 1
            else:
                nb = length - 59  # 1..4 extra length bytes
                length = int.from_bytes(buf[pos : pos + nb], "little") + 1
                pos += nb
            out += buf[pos : pos + length]
            pos += length
        else:
            if kind == 1:
                length = 4 + ((tag >> 2) & 0x7)
                offset = ((tag >> 5) << 8) | buf[pos]
                pos += 1
            elif kind == 2:
                length = (tag >> 2) + 1
                offset = int.from_bytes(buf[pos : pos + 2], "little")
                pos += 2
            else:
                length = (tag >> 2) + 1
                offset = int.from_bytes(buf[pos : pos + 4], "little")
                pos += 4
            if offset == 0:
                raise ValueError("snappy: zero copy offset")
            start = len(out) - offset
            if start < 0:
                raise ValueError("snappy: copy before start of output")
            # Copies may overlap forward (run-length encoding).
            for i in range(length):
                out.append(out[start + i])
    if len(out) != n:
        raise ValueError(f"snappy: decoded {len(out)} bytes, header said {n}")
    return bytes(out)


def block_compress(buf: bytes) -> bytes:
    """Compress one snappy block.

    Greedy hash-table matcher over 4-byte anchors — same scheme every snappy
    implementation uses; emits literal runs and copy-2 tags.
    """
    n = len(buf)
    out = bytearray(_write_varint(n))

    def emit_literal(lo, hi):
        length = hi - lo
        while length > 0:
            take = min(length, 1 << 24)
            L = take - 1
            if L < 60:
                out.append(L << 2)
            elif L < (1 << 8):
                out.append(60 << 2)
                out.append(L)
            elif L < (1 << 16):
                out.append(61 << 2)
                out.extend(L.to_bytes(2, "little"))
            else:
                out.append(62 << 2)
                out.extend(L.to_bytes(3, "little"))
            out.extend(buf[lo : lo + take])
            lo += take
            length -= take

    if n < 4:
        emit_literal(0, n)
        return bytes(out)

    table = {}
    i = 0
    lit_start = 0
    limit = n - 3
    while i < limit:
        key = buf[i : i + 4]
        cand = table.get(key, -1)
        table[key] = i
        if cand >= 0 and i - cand < 65536 and buf[cand : cand + 4] == key:
            # extend match
            m = 4
            while i + m < n and buf[cand + m] == buf[i + m]:
                m += 1
            emit_literal(lit_start, i)
            offset = i - cand
            rem = m
            while rem > 0:
                take = min(rem, 64)
                if take < 4:
                    # tail too short for a copy tag; emit as literal
                    emit_literal(i + m - rem, i + m)
                    break
                out.append(((take - 1) << 2) | 2)
                out.extend(offset.to_bytes(2, "little"))
                rem -= take
            i += m
            lit_start = i
        else:
            i += 1
    emit_literal(lit_start, n)
    return bytes(out)


# ------------------------------------------------------------ framed codec ---


def decompress(data: bytes) -> bytes:
    """Decode a full framed .sz stream held in memory."""
    from . import native

    nat = native.frame_decompress(data) if native.get_lib() else None
    if nat is not None:
        return nat
    return _decompress_py(data)


def _decompress_py(data: bytes) -> bytes:
    if not data:
        # golang/snappy's buffered writer emits the stream identifier lazily;
        # a zero-write stream is a zero-byte file.
        return b""
    if not data.startswith(_IDENT[:4]):
        raise ValueError("not a snappy framed stream")
    pos = 0
    out = bytearray()
    n = len(data)
    while pos < n:
        typ = data[pos]
        length = int.from_bytes(data[pos + 1 : pos + 4], "little")
        payload = data[pos + 4 : pos + 4 + length]
        pos += 4 + length
        if typ == 0xFF:  # stream identifier
            continue
        if typ == 0x00:
            chunk = block_decompress(payload[4:])
            out += chunk
        elif typ == 0x01:
            out += payload[4:]
        elif 0x02 <= typ <= 0x7F:
            raise ValueError(f"snappy: unskippable chunk type {typ:#x}")
        # 0x80..0xfe: skippable, ignore
    return bytes(out)


def compress(data: bytes, level: int = 1) -> bytes:
    """Encode bytes as a framed .sz stream.

    level 0 writes uncompressed chunks (fast, valid); level 1 compresses.
    """
    from . import native

    if level > 0 and native.get_lib():
        nat = native.frame_compress(data)
        if nat is not None:
            return nat
    return _compress_py(data, level)


def _compress_py(data: bytes, level: int = 1) -> bytes:
    out = bytearray(_IDENT)
    for off in range(0, len(data), _MAX_CHUNK):
        chunk = data[off : off + _MAX_CHUNK]
        crc = struct.pack("<I", masked_crc32c(chunk))
        if level > 0:
            comp = block_compress(chunk)
            if len(comp) < len(chunk):
                payload = crc + comp
                out.append(0x00)
            else:
                payload = crc + chunk
                out.append(0x01)
        else:
            payload = crc + chunk
            out.append(0x01)
        out += len(payload).to_bytes(3, "little")
        out += payload
    if not data:
        pass
    return bytes(out)


# ------------------------------------------------------- file conveniences ---


def read_bytes(path: str) -> bytes:
    """Read a file, transparently decoding .sz / .gz by suffix."""
    lower = path.lower()
    with open(path, "rb") as f:
        raw = f.read()
    if lower.endswith(".sz"):
        return decompress(raw)
    if lower.endswith(".gz"):
        import gzip

        return gzip.decompress(raw)
    return raw


def write_bytes(path: str, data: bytes) -> None:
    """Write a file, transparently encoding as .sz by suffix."""
    if path.lower().endswith(".sz"):
        data = compress(data)
    with open(path, "wb") as f:
        f.write(data)


class StreamWriter:
    """Incremental framed-.sz file writer.

    Frames are independent (IDENT header + self-contained 64KB chunks),
    so re-blocking the input to _MAX_CHUNK boundaries makes the output
    BYTE-IDENTICAL to `write_bytes(path, whole)` regardless of how the
    caller slices its writes — which lets large emitters (the 100M-read
    reads_sorted.txt.sz writer materialized a ~12GB blob plus copies)
    stream in bounded memory.  Non-.sz paths pass bytes through.
    """

    def __init__(self, path: str):
        self._f = open(path, "wb")
        self._sz = path.lower().endswith(".sz")
        self._carry = b""
        self._first = True

    def write(self, data) -> None:
        data = bytes(data)
        if not self._sz:
            self._f.write(data)
            return
        buf = self._carry + data if self._carry else data
        aligned = len(buf) - (len(buf) % _MAX_CHUNK)
        if aligned:
            out = compress(buf[:aligned])
            self._f.write(out if self._first else out[len(_IDENT):])
            self._first = False
        self._carry = buf[aligned:]

    def close(self) -> None:
        if self._sz and (self._carry or self._first):
            out = compress(self._carry)
            self._f.write(out if self._first else out[len(_IDENT):])
            self._carry = b""
            self._first = False
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
