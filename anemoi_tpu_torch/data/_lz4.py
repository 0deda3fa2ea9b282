"""LZ4 *block* format codec (vendored, dependency-free).

The port's copy of ``anemoi_tpu.data._lz4``.  The C decoder is a host codec
(it runs on the prefetch thread, not on the card); it is built with the
machine's C compiler into ``build/host/`` of the checkout, and the
pure-Python decoder serves when no compiler is present.
:func:`decoded_blocks` counts the blocks each one decoded.

The anemoi-datasets production stores are zarr v2 with numcodecs' Blosc
compressor, whose default codec is LZ4 (ref
training/src/anemoi/training/data/data_reader.py:86 reads them via
anemoi-datasets/zarr).  The port depends on no blosc or lz4 package, so
this module implements the LZ4 block format
(https://github.com/lz4/lz4/blob/dev/doc/lz4_Block_format.md) directly:

- ``decompress`` — safe decoder.  Uses a small C helper compiled on first
  use (ctypes) because data-loader throughput is a first-class concern;
  falls back to a pure Python decoder when no compiler is available.
- ``compress`` — greedy hash-chain encoder (used by the blosc writer in
  `_blosc.py` and by tests to produce byte-valid streams; correctness over
  ratio).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional

_C_SOURCE = r"""
#include <stdint.h>
#include <string.h>

/* Safe LZ4 block decoder.  Returns decoded size, or -1 on malformed input. */
long lz4_block_decompress(const uint8_t *src, long slen,
                          uint8_t *dst, long dcap) {
    const uint8_t *ip = src, *iend = src + slen;
    uint8_t *op = dst, *oend = dst + dcap;
    while (ip < iend) {
        unsigned token = *ip++;
        unsigned long ll = token >> 4;
        if (ll == 15) {
            unsigned s;
            do { if (ip >= iend) return -1; s = *ip++; ll += s; } while (s == 255);
        }
        if ((long)ll > iend - ip || (long)ll > oend - op) return -1;
        memcpy(op, ip, ll); op += ll; ip += ll;
        if (ip >= iend) break;            /* last sequence: literals only */
        if (iend - ip < 2) return -1;
        unsigned offset = (unsigned)ip[0] | ((unsigned)ip[1] << 8);
        ip += 2;
        if (offset == 0 || (long)offset > op - dst) return -1;
        unsigned long ml = token & 15;
        if (ml == 15) {
            unsigned s;
            do { if (ip >= iend) return -1; s = *ip++; ml += s; } while (s == 255);
        }
        ml += 4;
        if ((long)ml > oend - op) return -1;
        const uint8_t *ref = op - offset;
        if (offset >= ml) { memcpy(op, ref, ml); op += ml; }
        else { /* overlapping match: byte-wise copy is the semantics */
            for (unsigned long i = 0; i < ml; i++) op[i] = ref[i];
            op += ml;
        }
    }
    return (long)(op - dst);
}
"""

_native: Optional[ctypes.CDLL] = None
_native_tried = False
_decoded = {"C": 0, "python": 0}  # blocks decoded by each decoder


BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "host"


def _cache_dir() -> str:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    return str(BUILD_DIR)


def _load_native() -> Optional[ctypes.CDLL]:
    """Compile the C decoder once per source-hash and dlopen it."""
    global _native, _native_tried
    if _native is not None or _native_tried:
        return _native
    _native_tried = True
    if os.environ.get("ANEMOI_TPU_NO_NATIVE_LZ4"):
        return None
    try:
        tag = hashlib.sha256(_C_SOURCE.encode()).hexdigest()[:16]
        so_path = os.path.join(_cache_dir(), f"lz4dec_{tag}.so")
        if not os.path.exists(so_path):
            # per-process scratch names: concurrent first uses do not collide
            stem = f"{so_path[:-3]}.{os.getpid()}"
            with open(stem + ".c", "w") as f:
                f.write(_C_SOURCE)
            try:
                for cc in ("cc", "gcc", "g++", "clang"):
                    try:
                        subprocess.run(
                            [cc, "-O3", "-shared", "-fPIC", stem + ".c", "-o", stem + ".tmp"],
                            check=True, capture_output=True, timeout=120,
                        )
                        os.replace(stem + ".tmp", so_path)
                        break
                    except (OSError, subprocess.SubprocessError):
                        continue
                else:
                    return None
            finally:
                os.remove(stem + ".c")
        lib = ctypes.CDLL(so_path)
        lib.lz4_block_decompress.restype = ctypes.c_long
        lib.lz4_block_decompress.argtypes = [
            ctypes.c_char_p, ctypes.c_long,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_long,
        ]
        _native = lib
    except Exception:
        _native = None
    return _native


def _decompress_py(src: bytes, dst_size: int) -> bytes:
    """Pure-Python safe decoder (fallback path; same logic as the C one)."""
    ip, iend = 0, len(src)
    dst = bytearray(dst_size)
    op = 0
    while ip < iend:
        token = src[ip]
        ip += 1
        ll = token >> 4
        if ll == 15:
            while True:
                if ip >= iend:
                    raise ValueError("lz4: truncated literal length")
                s = src[ip]
                ip += 1
                ll += s
                if s != 255:
                    break
        if ip + ll > iend or op + ll > dst_size:
            raise ValueError("lz4: literal run out of bounds")
        dst[op : op + ll] = src[ip : ip + ll]
        op += ll
        ip += ll
        if ip >= iend:
            break  # last sequence carries only literals
        if ip + 2 > iend:
            raise ValueError("lz4: truncated offset")
        offset = src[ip] | (src[ip + 1] << 8)
        ip += 2
        if offset == 0 or offset > op:
            raise ValueError("lz4: bad match offset")
        ml = token & 15
        if ml == 15:
            while True:
                if ip >= iend:
                    raise ValueError("lz4: truncated match length")
                s = src[ip]
                ip += 1
                ml += s
                if s != 255:
                    break
        ml += 4
        if op + ml > dst_size:
            raise ValueError("lz4: match run out of bounds")
        ref = op - offset
        if offset >= ml:
            dst[op : op + ml] = dst[ref : ref + ml]
            op += ml
        else:  # overlapping match: repeat the window
            for i in range(ml):
                dst[op + i] = dst[ref + i]
            op += ml
    return bytes(dst[:op])


def decoded_blocks() -> dict:
    """The blocks this process decoded so far, by decoder (``"C"``, ``"python"``)."""
    return dict(_decoded)


def decompress(src: bytes, dst_size: int) -> bytes:
    """Decode one LZ4 block into exactly ``dst_size`` bytes."""
    lib = _load_native()
    if lib is not None:
        out = (ctypes.c_uint8 * dst_size)()
        n = lib.lz4_block_decompress(src, len(src), out, dst_size)
        if n < 0:
            raise ValueError("lz4: malformed block")
        _decoded["C"] += 1
        return bytes(bytearray(out)[:n])
    _decoded["python"] += 1
    return _decompress_py(src, dst_size)


def compress(src: bytes) -> bytes:
    """Greedy LZ4 block encoder (valid streams; modest ratio).

    Spec end rules honoured: the stream ends with a literals-only sequence,
    the last 5 bytes are literals, and no match starts within the last 12
    bytes of input.
    """
    n = len(src)
    out = bytearray()
    table: dict = {}
    anchor = 0  # start of pending literals
    i = 0
    limit = n - 12  # last match must not start in the final 12 bytes

    def emit(lit_start: int, lit_end: int, match_len: int, offset: int) -> None:
        ll = lit_end - lit_start
        ml = match_len - 4 if match_len else 0
        token = (min(ll, 15) << 4) | (min(ml, 15) if match_len else 0)
        out.append(token)
        if ll >= 15:
            rem = ll - 15
            while rem >= 255:
                out.append(255)
                rem -= 255
            out.append(rem)
        out.extend(src[lit_start:lit_end])
        if match_len:
            out.append(offset & 0xFF)
            out.append(offset >> 8)
            if ml >= 15:
                rem = ml - 15
                while rem >= 255:
                    out.append(255)
                    rem -= 255
                out.append(rem)

    while i < limit:
        key = src[i : i + 4]
        cand = table.get(key)
        table[key] = i
        if cand is not None and i - cand <= 0xFFFF and src[cand : cand + 4] == key:
            # extend the match, but never past the 5-byte literal tail
            end_cap = n - 5
            m = i + 4
            r = cand + 4
            while m < end_cap and src[m] == src[r]:
                m += 1
                r += 1
            emit(anchor, i, m - i, i - cand)
            anchor = m
            i = m
        else:
            i += 1
    emit(anchor, n, 0, 0)  # final literals-only sequence
    return bytes(out)
