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
import struct
from typing import Optional

import numpy as np

MAGIC = b"FHET"
VERSION = 1


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
    """Streaming reader: iterate chunks of k ciphertexts at a time."""

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
        self.count = header["count"]
        self.meta = header.get("meta", {})
        self._ct_bytes = self.size * self.L * self.n * 4

    def read(self, k: int) -> Optional[np.ndarray]:
        """Read up to k ciphertexts -> [m, size, L, n] or None at EOF.

        The array owns a writable buffer, so torch can adopt it without a
        copy."""
        left = os.fstat(self.f.fileno()).st_size - self.f.tell()
        m = min(k, left // self._ct_bytes)
        if m <= 0:
            return None
        arr = np.empty((m, self.size, self.L, self.n), dtype=np.uint32)
        got = self.f.readinto(memoryview(arr).cast("B"))
        if got != arr.nbytes:
            raise ValueError(f"short read: {got} of {arr.nbytes} bytes")
        return arr

    def close(self):
        self.f.close()

