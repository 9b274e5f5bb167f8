"""Minimal pure-python BGZF (blocked gzip) writer (the port's copy of
regenie_tpu/io/bgzf.py).

Replaces the reference's htslib dependency for the remeta LD-matrix
output (external_libs/remeta/bgz_writer.hpp): BGZF is a sequence of
gzip members each carrying a 'BC' extra subfield with the compressed
block size, terminated by a fixed 28-byte EOF block. Virtual offsets
(coffset << 16 | uoffset) match htslib's bgzf_tell semantics.
"""

from __future__ import annotations

import struct
import zlib

from .files import open_write_bytes

_MAX_BLOCK = 65280  # uncompressed payload per block (htslib default)
BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)


class BgzfWriter:
    """A BGZF file; off the output host of a multi-process run it keeps
    its offsets and writes nothing."""

    def __init__(self, path: str):
        self._fh = open_write_bytes(path)
        self._buf = bytearray()
        self._coffset = 0  # compressed bytes written so far

    def tell(self) -> int:
        """Virtual offset: (compressed block start) << 16 | within-block."""
        return (self._coffset << 16) | len(self._buf)

    def write(self, data: bytes):
        self._buf += data
        while len(self._buf) >= _MAX_BLOCK:
            self._flush_block(self._buf[:_MAX_BLOCK])
            del self._buf[:_MAX_BLOCK]

    def write_int32(self, v: int):
        self.write(struct.pack("<i", v))

    def write_float(self, v: float):
        self.write(struct.pack("<f", v))

    def write_str(self, s: str):
        self.write(s.encode())

    def _flush_block(self, payload: bytes):
        co = zlib.compressobj(6, zlib.DEFLATED, -15)
        comp = co.compress(bytes(payload)) + co.flush()
        bsize = len(comp) + 25 + 1  # header(12)+XLEN(6)+comp+crc(4)+isize(4)
        header = struct.pack(
            "<BBBBIBBHBBHH",
            0x1F, 0x8B, 8, 4,  # magic, CM=deflate, FLG=FEXTRA
            0, 0, 0xFF,        # MTIME, XFL, OS
            6,                 # XLEN
            0x42, 0x43, 2,     # 'B','C', SLEN
            bsize - 1,
        )
        tail = struct.pack("<II", zlib.crc32(bytes(payload)) & 0xFFFFFFFF,
                           len(payload))
        block = header + comp + tail
        self._fh.write(block)
        self._coffset += len(block)

    def close(self):
        if self._fh is None:
            return
        if self._buf:
            self._flush_block(bytes(self._buf))
            self._buf.clear()
        self._fh.write(BGZF_EOF)
        self._fh.close()
        self._fh = None
