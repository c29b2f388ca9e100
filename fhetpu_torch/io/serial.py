"""Ciphertext stream + key/params file formats: a JAX-free copy of
``fhetpu/io/serial.py``.  Streams and key files are byte-compatible both ways
with fhetpu's: the same 'FHET' magic, header and raw uint32 limb data.

The reference's inter-process protocol is plain files: keys/params.txt,
keys/pubkey, keys/seckey, and raw concatenations of ciphertexts.  Streams
are chunk-appendable so the server can stream blocks through bounded host
memory.
"""

from __future__ import annotations

import json
import os
import stat
import struct
from typing import Optional

import numpy as np

MAGIC = b"FHET"
VERSION = 1
READ_ALL_CHUNK_BYTES = 256 << 20  # CtReader.read_all's largest read on a pipe


def write_params_txt(path: str, width: int, height: int, channels: int, pmod: int):
    """Reference format: 'W H C pmod\\n' (client_jpeg.cpp:88-94)."""
    with open(path, "w") as f:
        f.write(f"{width} {height} {channels} {pmod}\n")


def read_params_txt(path: str):
    with open(path) as f:
        parts = f.read().split()
    return tuple(int(x) for x in parts)


def save_secret_key(path: str, small: np.ndarray):
    np.savez_compressed(path, secret=small)


def load_secret_key(path: str) -> np.ndarray:
    return np.load(path)["secret"]


def save_public_key(path: str, data: np.ndarray):
    np.savez_compressed(path, public=data)


def load_public_key(path: str) -> np.ndarray:
    return np.load(path)["public"]


# --- ciphertext streams -----------------------------------------------------


class CtWriter:
    """Appends fixed-shape ciphertext chunks [k, size, L, n] to a stream."""

    def __init__(self, path: str, size: int, L: int, n: int, meta: Optional[dict] = None):
        self.f = open(path, "wb")
        self.size, self.L, self.n = size, L, n
        self.count = 0
        self.meta = meta or {}
        header = {
            "size": size,
            "L": L,
            "n": n,
            "count": -1,
            "meta": self.meta,
        }
        # 16 bytes of slack so close() can rewrite with the real count
        hb = json.dumps(header).encode() + b" " * 16
        self.f.write(MAGIC + struct.pack("<II", VERSION, len(hb)) + hb)
        self._header_len = len(hb)

    def append(self, arr: np.ndarray):
        if arr.shape[-3:] != (self.size, self.L, self.n):
            raise ValueError(f"chunk shape {arr.shape} does not end in "
                             f"{(self.size, self.L, self.n)}")
        flat = np.ascontiguousarray(arr, dtype=np.uint32)
        self.count += int(np.prod(arr.shape[:-3])) if arr.ndim > 3 else 1
        self.f.write(flat.tobytes())

    def close(self):
        # rewrite header with the final count (fixed-length via padding),
        # PRESERVING meta -- downstream stages read layout/ntt flags from it
        self.f.seek(len(MAGIC) + 8)
        header = {
            "size": self.size,
            "L": self.L,
            "n": self.n,
            "count": self.count,
            "meta": self.meta,
        }
        hb = json.dumps(header).encode()
        assert len(hb) <= self._header_len, "header slack exhausted"
        self.f.write(hb + b" " * (self._header_len - len(hb)))
        self.f.close()


class CtReader:
    """Streaming reader: iterate chunks of k ciphertexts at a time.

    Reads a regular file or a pipe (a FIFO, ``/dev/stdin``) alike, as
    fhetpu's reader does: a read returns the whole ciphertexts it got and
    drops a trailing partial one."""

    def __init__(self, path: str):
        self.f = open(path, "rb")
        magic = self.f.read(4)
        if magic != MAGIC:
            self.f.close()
            raise ValueError(f"bad ciphertext stream magic {magic!r}")
        version, hlen = struct.unpack("<II", self.f.read(8))
        header = json.loads(self.f.read(hlen))
        self.size = header["size"]
        self.L = header["L"]
        self.n = header["n"]
        # -1 until CtWriter.close patches it: a bound on read_all's chunk only
        self.count = header["count"]
        self.meta = header.get("meta", {})
        self._ct_bytes = self.size * self.L * self.n * 4
        self._regular = stat.S_ISREG(os.fstat(self.f.fileno()).st_mode)
        self._done = 0  # whole ciphertexts returned so far
        # read_all's chunk on a pipe, in ciphertexts
        self.chunk = max(READ_ALL_CHUNK_BYTES // self._ct_bytes, 1)

    def read(self, k: int) -> Optional[np.ndarray]:
        """Read up to k ciphertexts -> [m, size, L, n], or None when no byte
        is left.  A trailing partial ciphertext is read and dropped, so m
        may be 0, as with fhetpu's reader.  On a regular file the buffer is
        sized by the bytes left, on a pipe by k.  The array owns a writable
        buffer, so torch can adopt it without a copy."""
        want = k * self._ct_bytes
        if self._regular:
            left = os.fstat(self.f.fileno()).st_size - self.f.tell()
            if left <= 0:
                return None
            if want >= left:  # this read reaches the end: take the partial tail too
                want = left
        arr = self._buffer(min(k, want // self._ct_bytes))
        got = self._fill(memoryview(arr.reshape(-1).view(np.uint8)))
        if got == arr.nbytes and want > got:  # the bytes past the whole ones
            got += len(self.f.read(want - got))
        if got == 0:
            return None
        m = got // self._ct_bytes
        self._done += m
        return arr[:m]

    def read_all(self) -> np.ndarray:
        """The rest of the stream -> [m, size, L, n] (m = 0 at EOF).  On a
        regular file one read sized by the bytes left; on a pipe reads of
        at most ``self.chunk`` ciphertexts (fewer where the header's count
        bounds the rest), joined at EOF."""
        if self._regular:
            out = self.read(1 << 62)
            return self._empty() if out is None else out
        parts = []
        while True:
            rest = self.count - self._done
            k = min(self.chunk, rest) if rest > 0 else self.chunk
            out = self.read(k)
            if out is None:
                break
            parts.append(out)
            if out.shape[0] < k:  # the pipe reached EOF inside this read
                break
        if not parts:
            return self._empty()
        return parts[0] if len(parts) == 1 else np.concatenate(parts)

    def _buffer(self, m: int) -> np.ndarray:
        return np.empty((m, self.size, self.L, self.n), dtype=np.uint32)

    def _empty(self) -> np.ndarray:
        return np.zeros((0, self.size, self.L, self.n), np.uint32)

    def _fill(self, view: memoryview) -> int:
        """readinto until view is full or the stream ends (a pipe returns
        short reads); the number of bytes read."""
        got = 0
        while got < len(view):
            r = self.f.readinto(view[got:])
            if not r:
                break
            got += r
        return got

    def close(self):
        self.f.close()


def write_ct_array(path: str, arr: np.ndarray, meta: Optional[dict] = None):
    """One-shot write of [count, size, L, n]."""
    w = CtWriter(path, arr.shape[-3], arr.shape[-2], arr.shape[-1], meta)
    w.append(arr.reshape(-1, *arr.shape[-3:]))
    w.close()
