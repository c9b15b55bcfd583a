"""Pure-Python LZ4 frame codec (decompress + simple compress).

Real dives commonly record rosbags with ``lz4`` chunk compression (written
by roslz4, which emits the standard LZ4 Frame Format v1.6.x). When the
C-accelerated ``lz4`` package is importable :mod:`uslam_tpu_torch.io.rosbag`
uses it; otherwise it uses this self-contained codec (the JAX package's
``uslam_tpu.io.lz4f``, copied so the port imports nothing of it).

Scope: everything a rosbag chunk needs —
- frame parsing (FLG/BD descriptor, optional content size / dict id,
  block checksums and content checksum are *skipped*, not verified),
- LZ4 block decompression (token / literal runs / 16-bit-offset matches
  with overlap semantics, linked blocks supported by decoding into one
  growing output buffer),
- a greedy hash-chain block compressor for the writer and tests
  (spec-conformant output; ratio is not the point here).

Format reference: the public LZ4 frame + block format specs
(github.com/lz4/lz4/blob/dev/doc). Written from the spec, not from any
implementation.
"""

from __future__ import annotations

import struct

_MAGIC = 0x184D2204
# Block-max-size table: BD byte bits 4-6 value 4..7.
_BLOCK_MAX = {4: 1 << 16, 5: 1 << 18, 6: 1 << 20, 7: 1 << 22}

_MIN_MATCH = 4
# Spec: the last 5 bytes of a block are always literals; matches must not
# start within the last 12 bytes.
_MFLIMIT = 12
_LAST_LITERALS = 5


def decompress_block(src: bytes, out: bytearray) -> None:
    """Decompress one LZ4 block, appending to ``out``.

    Matches may reference bytes already in ``out`` from previous blocks
    (linked-block mode); offsets are validated against len(out).
    """
    pos = 0
    n = len(src)
    base = len(out)
    while pos < n:
        token = src[pos]
        pos += 1
        # Literal run.
        lit = token >> 4
        if lit == 15:
            while True:
                b = src[pos]
                pos += 1
                lit += b
                if b != 255:
                    break
        if lit:
            if pos + lit > n:
                raise ValueError("lz4: literal run past end of block")
            out += src[pos : pos + lit]
            pos += lit
        if pos >= n:
            break  # last sequence: literals only
        # Match.
        offset = src[pos] | (src[pos + 1] << 8)
        pos += 2
        if offset == 0 or offset > len(out):
            raise ValueError(f"lz4: bad match offset {offset} at {base}+{pos}")
        mlen = (token & 0x0F) + _MIN_MATCH
        if mlen == 15 + _MIN_MATCH:
            while True:
                b = src[pos]
                pos += 1
                mlen += b
                if b != 255:
                    break
        start = len(out) - offset
        if offset >= mlen:
            out += out[start : start + mlen]
        else:
            # Overlapping match: byte-at-a-time semantics (RLE-style).
            for i in range(mlen):
                out.append(out[start + i])


def decompress(data: bytes) -> bytes:
    """Decompress a complete LZ4 frame (concatenated frames supported)."""
    out = bytearray()
    pos = 0
    n = len(data)
    while pos < n:
        (magic,) = struct.unpack_from("<I", data, pos)
        pos += 4
        if magic == _MAGIC:
            flg = data[pos]
            bd = data[pos + 1]
            pos += 2
            version = (flg >> 6) & 0x3
            if version != 1:
                raise ValueError(f"lz4: unsupported frame version {version}")
            b_checksum = bool(flg & 0x10)
            c_size = bool(flg & 0x08)
            c_checksum = bool(flg & 0x04)
            dict_id = bool(flg & 0x01)
            if (bd >> 4) & 0x7 not in _BLOCK_MAX:
                raise ValueError("lz4: invalid block max size")
            if c_size:
                pos += 8
            if dict_id:
                pos += 4
            pos += 1  # header checksum byte (not verified)
            while True:
                (bsize,) = struct.unpack_from("<I", data, pos)
                pos += 4
                if bsize == 0:  # EndMark
                    break
                uncompressed = bool(bsize & 0x80000000)
                bsize &= 0x7FFFFFFF
                block = data[pos : pos + bsize]
                if len(block) != bsize:
                    raise ValueError("lz4: truncated block")
                pos += bsize
                if uncompressed:
                    out += block
                else:
                    decompress_block(block, out)
                if b_checksum:
                    pos += 4  # per-block xxh32 (not verified)
            if c_checksum:
                pos += 4  # content xxh32 (not verified)
        elif 0x184D2A50 <= magic <= 0x184D2A5F:
            # Skippable frame.
            (size,) = struct.unpack_from("<I", data, pos)
            pos += 4 + size
        else:
            raise ValueError(f"lz4: bad magic {magic:#x}")
    return bytes(out)


def _write_varlen(buf: bytearray, value: int) -> None:
    while value >= 255:
        buf.append(255)
        value -= 255
    buf.append(value)


def compress_block(src: bytes) -> bytes:
    """Greedy LZ4 block compressor (hash table on 4-byte windows)."""
    n = len(src)
    out = bytearray()
    table: dict[bytes, int] = {}
    anchor = 0
    pos = 0
    limit = n - _MFLIMIT
    while pos < limit:
        key = src[pos : pos + 4]
        cand = table.get(key)
        table[key] = pos
        if cand is None or pos - cand > 0xFFFF or src[cand : cand + 4] != key:
            pos += 1
            continue
        # Extend the match forward (must leave the last-5 literals).
        mlen = 4
        max_len = n - _LAST_LITERALS - pos
        while mlen < max_len and src[cand + mlen] == src[pos + mlen]:
            mlen += 1
        lit = src[anchor:pos]
        lit_len = len(lit)
        token_lit = 15 if lit_len >= 15 else lit_len
        token_match = 15 if mlen - _MIN_MATCH >= 15 else mlen - _MIN_MATCH
        out.append((token_lit << 4) | token_match)
        if lit_len >= 15:
            _write_varlen(out, lit_len - 15)
        out += lit
        out += struct.pack("<H", pos - cand)
        if mlen - _MIN_MATCH >= 15:
            _write_varlen(out, mlen - _MIN_MATCH - 15)
        pos += mlen
        anchor = pos
    # Trailing literals.
    lit = src[anchor:]
    lit_len = len(lit)
    token_lit = 15 if lit_len >= 15 else lit_len
    out.append(token_lit << 4)
    if lit_len >= 15:
        _write_varlen(out, lit_len - 15)
    out += lit
    return bytes(out)


def compress(data: bytes) -> bytes:
    """Produce a minimal valid LZ4 frame (independent 4 MiB blocks, no
    checksums beyond the mandatory header checksum byte)."""
    out = bytearray()
    out += struct.pack("<I", _MAGIC)
    flg = (1 << 6) | (1 << 5)  # version 01, block-independent
    bd = 7 << 4  # 4 MiB max block
    out.append(flg)
    out.append(bd)
    out.append(_header_checksum(bytes([flg, bd])))
    block_max = _BLOCK_MAX[7]
    for off in range(0, len(data), block_max) or [0]:
        raw = data[off : off + block_max]
        if not raw:
            continue
        comp = compress_block(raw)
        if len(comp) < len(raw):
            out += struct.pack("<I", len(comp))
            out += comp
        else:
            out += struct.pack("<I", 0x80000000 | len(raw))
            out += raw
    out += struct.pack("<I", 0)  # EndMark
    return bytes(out)


def _xxh32(data: bytes, seed: int = 0) -> int:
    """xxHash32 (needed only to stamp the frame-header checksum byte)."""
    P1, P2, P3, P4, P5 = (
        2654435761, 2246822519, 3266489917, 668265263, 374761393,
    )
    mask = 0xFFFFFFFF

    def rotl(x, r):
        return ((x << r) | (x >> (32 - r))) & mask

    n = len(data)
    idx = 0
    if n >= 16:
        v1 = (seed + P1 + P2) & mask
        v2 = (seed + P2) & mask
        v3 = seed & mask
        v4 = (seed - P1) & mask
        while idx <= n - 16:
            for vi in range(4):
                (lane,) = struct.unpack_from("<I", data, idx)
                idx += 4
                if vi == 0:
                    v1 = (rotl((v1 + lane * P2) & mask, 13) * P1) & mask
                elif vi == 1:
                    v2 = (rotl((v2 + lane * P2) & mask, 13) * P1) & mask
                elif vi == 2:
                    v3 = (rotl((v3 + lane * P2) & mask, 13) * P1) & mask
                else:
                    v4 = (rotl((v4 + lane * P2) & mask, 13) * P1) & mask
        h = (rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18)) & mask
    else:
        h = (seed + P5) & mask
    h = (h + n) & mask
    while idx <= n - 4:
        (lane,) = struct.unpack_from("<I", data, idx)
        idx += 4
        h = (rotl((h + lane * P3) & mask, 17) * P4) & mask
    while idx < n:
        h = (rotl((h + data[idx] * P5) & mask, 11) * P1) & mask
        idx += 1
    h ^= h >> 15
    h = (h * P2) & mask
    h ^= h >> 13
    h = (h * P3) & mask
    h ^= h >> 16
    return h


def _header_checksum(descriptor: bytes) -> int:
    return (_xxh32(descriptor) >> 8) & 0xFF
