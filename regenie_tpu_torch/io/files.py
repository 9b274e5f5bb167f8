"""File primitives: text IO and table helpers (the port's copy of
regenie_tpu/io/files.py, single-process: every run writes its own files).

Equivalent of the reference's `src/Files.{hpp,cpp}` (string_split and
gz-transparent reads).
"""

from __future__ import annotations

import gzip
import io
import re
from typing import IO, Iterator, List


def open_read(path: str) -> IO[str]:
    """Open a text file, transparently handling .gz (Files.hpp:36-100)."""
    if path.endswith(".gz"):
        return io.TextIOWrapper(gzip.open(path, "rb"), encoding="utf-8")
    return open(path, "r", encoding="utf-8")


def open_write(path: str) -> IO[str]:
    return open(path, "w", encoding="utf-8")


_SPLIT_RE = re.compile(r"[ \t]+")


def string_split(line: str) -> List[str]:
    """Split on spaces/tabs, like reference string_split(line, "\\t ")."""
    return [t for t in _SPLIT_RE.split(line.strip("\r\n")) if t]


def iter_lines(path: str) -> Iterator[List[str]]:
    with open_read(path) as fh:
        for line in fh:
            toks = string_split(line)
            if toks:
                yield toks
