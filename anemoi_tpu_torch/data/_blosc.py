"""Blosc(1) chunk codec (vendored, dependency-free).

The port's copy of ``anemoi_tpu.data._blosc``.

anemoi-datasets production zarr stores use numcodecs' Blosc compressor
(c-blosc 1.x frame format, default cname="lz4", byte shuffle) — ref
training/src/anemoi/training/data/data_reader.py:86 reads them through
anemoi-datasets/zarr.  The port depends on no blosc package, so this module
implements the c-blosc 1.x chunk format directly
(https://github.com/Blosc/c-blosc/blob/main/README_CHUNK_FORMAT.rst):

16-byte header::

    byte 0    format version (2 for c-blosc 1.x)
    byte 1    codec version
    byte 2    flags: 0x1 byte-shuffle | 0x2 memcpy'ed | 0x4 bit-shuffle |
              0x10 dont-split | codec id in bits 5-7
    byte 3    typesize
    4..7      nbytes   (uncompressed size, little-endian uint32)
    8..11     blocksize
    12..15    cbytes   (total compressed size including header)

Non-memcpy chunks follow with ``nblocks`` little-endian int32 block start
offsets (relative to the chunk start), then per block 1 or ``typesize``
compressed streams, each prefixed by its int32 compressed size; a stream
whose size equals its uncompressed size is stored raw.  Blocks are
byte-shuffled before splitting, so each split stream is one byte plane.

Supported codecs: lz4/lz4hc (vendored `_lz4`), zlib (stdlib).  blosclz,
snappy and zstd raise a clear error naming the codec — no stdlib decoder
exists for them and anemoi stores default to lz4.
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional

import numpy as np

from anemoi_tpu_torch.data import _lz4

# flag bits (c-blosc blosc.h)
DOSHUFFLE = 0x1
MEMCPYED = 0x2
DOBITSHUFFLE = 0x4
DONT_SPLIT = 0x10

# codec ids stored in flag bits 5-7 (c-blosc "compressor format" codes)
_CODEC_BLOSCLZ = 0
_CODEC_LZ4 = 1
_CODEC_SNAPPY = 2
_CODEC_ZLIB = 3
_CODEC_ZSTD = 4

_MAX_SPLITS = 16  # c-blosc MAX_SPLITS: split blocks only for typesize <= 16


def _shuffle(typesize: int, block: bytes) -> bytes:
    """c-blosc byte shuffle: group byte plane k of every element together.
    The tail (len % typesize bytes) is copied through unshuffled."""
    n = len(block)
    nel = n // typesize
    body = np.frombuffer(block, np.uint8, count=nel * typesize)
    planes = body.reshape(nel, typesize).T.tobytes()
    return planes + block[nel * typesize :]


def _unshuffle(typesize: int, block: bytes) -> bytes:
    n = len(block)
    nel = n // typesize
    planes = np.frombuffer(block, np.uint8, count=nel * typesize)
    body = planes.reshape(typesize, nel).T.tobytes()
    return body + block[nel * typesize :]


def _codec_decompress(codec: int, payload: bytes, dst_size: int) -> bytes:
    if codec == _CODEC_LZ4:
        return _lz4.decompress(payload, dst_size)
    if codec == _CODEC_ZLIB:
        return zlib.decompress(payload)
    name = {_CODEC_BLOSCLZ: "blosclz", _CODEC_SNAPPY: "snappy",
            _CODEC_ZSTD: "zstd"}.get(codec, f"#{codec}")
    raise ValueError(
        f"blosc chunk uses the {name} codec; only lz4/lz4hc and zlib are "
        "supported (anemoi stores default to lz4 — re-write the store with "
        "cname='lz4' or 'zlib')"
    )


def decompress(raw: bytes) -> bytes:
    """Decode one blosc chunk to its uncompressed bytes."""
    if len(raw) < 16:
        raise ValueError("blosc: truncated header")
    version, _versionlz, flags, typesize = raw[0], raw[1], raw[2], raw[3]
    nbytes, blocksize, cbytes = struct.unpack_from("<III", raw, 4)
    if version < 1 or version > 2:
        raise ValueError(f"blosc: unsupported chunk format version {version}")
    if cbytes > len(raw):
        raise ValueError("blosc: truncated chunk")
    if nbytes == 0:
        return b""
    if flags & MEMCPYED:
        # stored verbatim (compression didn't pay); never shuffled
        if len(raw) < 16 + nbytes:
            raise ValueError("blosc: truncated memcpy chunk")
        return raw[16 : 16 + nbytes]
    if flags & DOBITSHUFFLE:
        raise ValueError(
            "blosc: bit-shuffled chunks are not supported (anemoi stores use "
            "byte shuffle); re-write with shuffle=SHUFFLE"
        )
    codec = (flags >> 5) & 0x7
    shuffled = bool(flags & DOSHUFFLE) and typesize > 1
    dont_split = bool(flags & DONT_SPLIT)

    nblocks = (nbytes + blocksize - 1) // blocksize
    bstarts = struct.unpack_from(f"<{nblocks}i", raw, 16)
    out = bytearray(nbytes)
    for b in range(nblocks):
        bsize = min(blocksize, nbytes - b * blocksize)
        leftover = bsize != blocksize
        if dont_split or leftover or typesize > _MAX_SPLITS or typesize <= 1:
            nstreams = 1
        else:
            nstreams = typesize
        neblock = bsize // nstreams
        pos = bstarts[b]
        block = bytearray()
        for _ in range(nstreams):
            (csize,) = struct.unpack_from("<i", raw, pos)
            pos += 4
            payload = raw[pos : pos + csize]
            pos += csize
            if csize == neblock:  # stored uncompressed
                part = bytes(payload)
            else:
                part = _codec_decompress(codec, payload, neblock)
            if len(part) != neblock:
                raise ValueError("blosc: stream decoded to wrong size")
            block += part
        if shuffled:
            block = _unshuffle(typesize, bytes(block))
        out[b * blocksize : b * blocksize + bsize] = block
    return bytes(out)


def _default_blocksize(nbytes: int, typesize: int) -> int:
    """A 64 KiB-ish block, forced to a typesize multiple (as c-blosc does)."""
    bs = min(nbytes, 1 << 16)
    bs = max(typesize, bs - bs % typesize)
    return bs


def compress(
    data: bytes,
    typesize: int,
    cname: str = "lz4",
    shuffle: int = 1,
    blocksize: Optional[int] = None,
    split: Optional[bool] = None,
) -> bytes:
    """Encode bytes as one blosc(1) chunk, byte-exact per the format above.

    ``split=None`` reproduces c-blosc's rule (split lz4/blosclz blocks when
    typesize <= 16); tests exercise both split and dont-split layouts.
    """
    codec = {"lz4": _CODEC_LZ4, "lz4hc": _CODEC_LZ4, "zlib": _CODEC_ZLIB}.get(cname)
    if codec is None:
        raise ValueError(f"unsupported blosc cname {cname!r} for writing")
    nbytes = len(data)
    typesize = max(1, min(typesize, 255))
    if nbytes == 0:
        return struct.pack("<BBBBIII", 2, 1, 0, typesize, 0, 0, 16)
    blocksize = blocksize or _default_blocksize(nbytes, typesize)
    do_shuffle = shuffle == 1 and typesize > 1
    if split is None:
        split = codec == _CODEC_LZ4 and 1 < typesize <= _MAX_SPLITS
    split = bool(split) and 1 < typesize <= _MAX_SPLITS

    flags = codec << 5
    if do_shuffle:
        flags |= DOSHUFFLE
    if not split:
        flags |= DONT_SPLIT

    nblocks = (nbytes + blocksize - 1) // blocksize
    streams = []  # per block: list of (csize, payload)
    for b in range(nblocks):
        block = data[b * blocksize : b * blocksize + min(blocksize, nbytes - b * blocksize)]
        bsize = len(block)
        leftover = bsize != blocksize
        if do_shuffle:
            block = _shuffle(typesize, block)
        nstreams = typesize if (split and not leftover) else 1
        neblock = bsize // nstreams
        parts = []
        for s in range(nstreams):
            piece = block[s * neblock : (s + 1) * neblock]
            comp = (
                _lz4.compress(piece) if codec == _CODEC_LZ4 else zlib.compress(piece, 5)
            )
            if len(comp) >= neblock:
                parts.append((neblock, piece))  # store raw
            else:
                parts.append((len(comp), comp))
        streams.append(parts)

    body = bytearray()
    bstarts = []
    offset = 16 + 4 * nblocks
    for parts in streams:
        bstarts.append(offset)
        for csize, payload in parts:
            body += struct.pack("<i", csize)
            body += payload
            offset += 4 + csize
    total = 16 + 4 * nblocks + len(body)
    if total >= nbytes + 16:  # compression didn't pay: memcpy chunk
        header = struct.pack(
            "<BBBBIII", 2, 1, (codec << 5) | MEMCPYED, typesize, nbytes,
            blocksize, nbytes + 16,
        )
        return header + data
    header = struct.pack(
        "<BBBBIII", 2, 1, flags, typesize, nbytes, blocksize, total
    )
    return header + struct.pack(f"<{nblocks}i", *bstarts) + bytes(body)
