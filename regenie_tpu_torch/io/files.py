"""File primitives: text IO and table helpers (the port's copy of
regenie_tpu/io/files.py, single-process: every run writes its own files).

Equivalent of the reference's `src/Files.{hpp,cpp}` (string_split,
gz-transparent reads and gzipped writes).
"""

from __future__ import annotations

import gzip
import io
import os
import re
from concurrent.futures import ThreadPoolExecutor
from typing import IO, Iterator, List


def open_read(path: str) -> IO[str]:
    """Open a text file, transparently handling .gz (Files.hpp:36-100)."""
    if path.endswith(".gz"):
        return io.TextIOWrapper(gzip.open(path, "rb"), encoding="utf-8")
    return open(path, "r", encoding="utf-8")


def open_write(path: str, gz: bool = False):
    """A text file for writing; with gz (or a .gz path) a GzipWriter on
    path + ".gz" (open_write, Files.hpp)."""
    if gz or path.endswith(".gz"):
        if not path.endswith(".gz"):
            path += ".gz"
        return GzipWriter(path)
    return open(path, "w", encoding="utf-8")


class GzipWriter:
    """Text-mode .gz writer whose buffered text flushes as independently
    deflated gzip members, compressed in parallel Python threads (zlib
    releases the interpreter lock), so the compression of a block's rows
    keeps pace with their rendering. The file is a standard multi-member
    gzip stream (RFC 1952 §2.2), which gzip.open and zcat read whole;
    its bytes differ from a single-stream writer's, its text does not.
    Members carry mtime 0, so the same text gives the same bytes."""

    FLUSH_AT = 8 << 20  # buffered bytes that trigger a flush
    PIECE = 1 << 20  # text bytes a member

    def __init__(self, path: str):
        self._fh = open(path, "wb")
        self._buf = bytearray()

    def write(self, s) -> int:
        """Buffer text (str) or bytes already encoded."""
        self._buf += s if isinstance(s, (bytes, bytearray)) else s.encode("utf-8")
        if len(self._buf) >= self.FLUSH_AT:
            self._flush_members()
        return len(s)

    def _flush_members(self):
        if not self._buf:
            return
        data = bytes(self._buf)
        self._buf.clear()
        pieces = [data[i : i + self.PIECE] for i in range(0, len(data), self.PIECE)]
        with ThreadPoolExecutor(min(len(pieces), os.cpu_count() or 1)) as pool:
            for member in pool.map(
                    lambda b: gzip.compress(b, compresslevel=6, mtime=0), pieces):
                self._fh.write(member)

    def close(self):
        if self._fh.closed:
            return
        try:
            self._flush_members()
        finally:
            self._fh.close()

    @property
    def closed(self):
        return self._fh.closed

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


_SPLIT_RE = re.compile(r"[ \t]+")
# whitespace that str.split() splits on and string_split keeps in a token
_OTHER_SPACE = "\r\n\v\f\x1c\x1d\x1e\x1f"


def string_split(line: str) -> List[str]:
    """Split on spaces/tabs, like reference string_split(line, "\\t ").
    An ASCII line with no other whitespace inside takes str.split(), which
    gives the same tokens at C speed (a .loco row holds N of them)."""
    s = line.strip("\r\n")
    if s.isascii() and not any(c in s for c in _OTHER_SPACE):
        return s.split()
    return [t for t in _SPLIT_RE.split(s) if t]


def iter_lines(path: str) -> Iterator[List[str]]:
    with open_read(path) as fh:
        for line in fh:
            toks = string_split(line)
            if toks:
                yield toks
