"""fhetpu_torch's ciphertext streams read from a pipe, as fhetpu reads them.

A FIFO (``os.mkfifo``, fed by a writer thread) and ``/dev/stdin`` fed
through a subprocess's pipe give the port's ``CtReader`` the same arrays as
fhetpu's, in ``read(k)`` and in ``read_all``; a trailing partial ciphertext
is dropped alike on a file and on a pipe; ``read_all`` on a pipe reads in
bounded chunks; and the port's ``server_jpeg`` on the CPU reads fhetpu's
client stream from a FIFO or from ``/dev/stdin`` into the bytes it writes
from the file.  fhetpu's ``read_all`` asks for 2^30 ciphertexts at once, so
fhetpu's side reads a known count instead.
"""

import contextlib
import os
import subprocess
import sys

import numpy as np
import pytest

from fhetpu.io import images
from fhetpu.io import serial as f_serial

from chip_smoke import feed_fifo
from fhetpu_torch.cli import server_jpeg
from fhetpu_torch.io import serial

SEED = 20261017
SHAPE = (2, 2, 16)  # size, L, n of the small streams
N, T = 2048, 1 << 14
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _stream(tmp_path, count: int, tail: int = 0, close: bool = True):
    """(bytes of a CtWriter stream of ``count`` seeded ciphertexts plus
    ``tail`` bytes of a partial one, the ciphertexts); ``close=False``
    leaves the header's count at -1, as a writer that has not closed."""
    rng = np.random.default_rng(SEED + count)
    cts = rng.integers(0, 1 << 32, size=(count,) + SHAPE, dtype=np.uint64).astype(np.uint32)
    path = str(tmp_path / f"stream_{count}_{tail}.bin")
    w = serial.CtWriter(path, *SHAPE, meta={"layout": "blocks"})
    w.append(cts)
    if close:
        w.close()
    else:
        w.f.close()
    with open(path, "ab") as f:
        f.write(rng.integers(0, 256, size=tail, dtype=np.uint8).tobytes())
    with open(path, "rb") as f:
        return f.read(), cts


def _reads(mod, path: str, ks) -> list:
    """What each read(k) returns in turn: None, or the array."""
    r = mod.CtReader(path)
    try:
        return [r.read(k) for k in ks]
    finally:
        r.close()


def _same(a, b) -> bool:
    if a is None or b is None:
        return a is None and b is None
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(a, b)


def test_fifo_reads_equal_fhetpu(tmp_path):
    """read(2) twice, then the rest, from a FIFO: the port's read_all equals
    fhetpu reading the known rest; every array equals the stream's, and the
    port's arrays are writable (torch adopts them without a copy)."""
    data, cts = _stream(tmp_path, 7)
    with feed_fifo(str(tmp_path / "ref"), data) as path:
        want = _reads(f_serial, path, [2, 2, 3, 1])
    with feed_fifo(str(tmp_path / "ours"), data) as path:
        r = serial.CtReader(path)
        got = [r.read(2), r.read(2), r.read_all(), r.read(1)]
        r.close()
    assert all(_same(a, b) for a, b in zip(got[:3], want[:3]))
    assert want[3] is None and got[3] is None
    assert np.array_equal(np.concatenate(got[:3]), cts)
    assert all(a.flags.writeable for a in got[:3])


def test_stdin_pipe_reads_equal_fhetpu(tmp_path):
    """The same stream piped into a subprocess that reads /dev/stdin with
    each package's reader: read(2) twice, then the rest."""
    data, cts = _stream(tmp_path, 5)
    code = ("import sys, numpy as np\n"
            "from {pkg}.io import serial\n"
            "r = serial.CtReader('/dev/stdin')\n"
            "a, b = r.read(2), r.read(2)\n"
            "c = {rest}\n"
            "np.savez(sys.argv[1], a=a, b=b, c=c, end=r.read(1) is None)\n")
    out = {}
    for pkg, rest in (("fhetpu", "r.read(1)"), ("fhetpu_torch", "r.read_all()")):
        out[pkg] = str(tmp_path / f"{pkg}.npz")
        subprocess.run([sys.executable, "-c", code.format(pkg=pkg, rest=rest), out[pkg]],
                       input=data, cwd=REPO, check=True, timeout=120)
    ref, ours = (np.load(out[pkg]) for pkg in ("fhetpu", "fhetpu_torch"))
    for key in "abc":
        assert _same(ours[key], ref[key])
    assert bool(ours["end"]) and bool(ref["end"])
    assert np.array_equal(np.concatenate([ours[k] for k in "abc"]), cts)


@pytest.mark.parametrize("source", ["file", "fifo"])
def test_trailing_partial_ciphertext_as_fhetpu(tmp_path, source):
    """Three ciphertexts and half of a fourth: each package drops the half,
    read by read(2) (2, then 1, then None) and by read(3) (3, then an empty
    array for the half, then None), from a file and from a FIFO; the port's
    read_all after read(2) returns the one whole ciphertext left."""
    half = np.prod(SHAPE) * 2
    data, cts = _stream(tmp_path, 3, tail=half)
    file_path = str(tmp_path / "partial.bin")
    with open(file_path, "wb") as f:
        f.write(data)
    seq = {}
    for name, mod in (("ref", f_serial), ("ours", serial)):
        for ks in ([2, 2, 2], [3, 3, 3]):
            if source == "file":
                seq[name, ks[0]] = _reads(mod, file_path, ks)
            else:
                with feed_fifo(str(tmp_path / f"{name}{ks[0]}"), data) as path:
                    seq[name, ks[0]] = _reads(mod, path, ks)
    for k in (2, 3):
        assert all(_same(a, b) for a, b in zip(seq["ours", k], seq["ref", k]))
    assert [None if a is None else a.shape[0] for a in seq["ours", 2]] == [2, 1, None]
    assert [None if a is None else a.shape[0] for a in seq["ours", 3]] == [3, 0, None]
    assert np.array_equal(seq["ours", 3][0], cts)
    src = file_path if source == "file" else str(tmp_path / "rest")
    with contextlib.ExitStack() as stack:
        if source == "fifo":
            stack.enter_context(feed_fifo(src, data))
        r = serial.CtReader(src)
        r.read(2)
        rest, end = r.read_all(), r.read_all()
        r.close()
    assert np.array_equal(rest, cts[2:]) and end.shape == (0,) + SHAPE


def test_read_all_on_a_fifo_reads_in_bounded_chunks(tmp_path, monkeypatch):
    """read_all on a FIFO never asks for more than its chunk: with a chunk
    of two ciphertexts, a stream of three whose header count is -1 (not
    trusted) and one whose count is 3 (a bound) come back whole, and no
    buffer holds more than two.  The default chunk stays within
    READ_ALL_CHUNK_BYTES."""
    ct_bytes = int(np.prod(SHAPE)) * 4
    assert serial.READ_ALL_CHUNK_BYTES <= 256 << 20
    sizes = []
    buffer = serial.CtReader._buffer

    def recording(self, m):
        sizes.append(m)
        return buffer(self, m)

    monkeypatch.setattr(serial.CtReader, "_buffer", recording)
    for close, want_sizes in ((False, [2, 2]), (True, [2, 1, 2])):
        data, cts = _stream(tmp_path, 3, close=close)
        with feed_fifo(str(tmp_path / f"chunks{close}"), data) as path:
            r = serial.CtReader(path)
            assert r.count == (3 if close else -1)
            assert r.chunk * ct_bytes <= serial.READ_ALL_CHUNK_BYTES
            assert r.chunk >= 3  # the default: the whole stream in one chunk
            r.chunk = 2
            sizes.clear()
            got = r.read_all()
            r.close()
        assert np.array_equal(got, cts)
        assert sizes == want_sizes and max(sizes) <= 2


@pytest.fixture(scope="module")
def client_stream(tmp_path_factory):
    """fhetpu's client_jpeg --send at n = 2048 on a seeded 16x16 image, and
    the port's server_jpeg --device cpu run on the file."""
    from fhetpu.cli import client_jpeg as f_client

    d = tmp_path_factory.mktemp("pipes")
    img = np.random.default_rng(SEED).integers(0, 256, size=(16, 16, 3), dtype=np.uint8)
    img_path = str(d / "in.png")
    images.save_rgb(img_path, img)
    keys = ["--keydir", str(d / "keys")]
    c2s, s2c = str(d / "c2s.bin"), str(d / "s2c_file.bin")
    f_client.main(["--send", "-f", img_path, "-c", c2s, "--cmod", str(N),
                   "--pmod", str(T)] + keys)
    server_jpeg.main(["-i", c2s, "-c", s2c, "--device", "cpu"] + keys)
    with open(c2s, "rb") as f, open(s2c, "rb") as g:
        return d, keys, f.read(), g.read()


@pytest.mark.parametrize("source", ["fifo", "stdin"])
def test_port_server_reads_fhetpu_client_from_a_pipe(client_stream, source):
    """The port's server_jpeg --device cpu reads fhetpu's client stream from
    a FIFO (in process) or from /dev/stdin (a subprocess fed through a pipe)
    and writes the stream it writes from the file, byte for byte."""
    d, keys, c2s, want = client_stream
    s2c = str(d / f"s2c_{source}.bin")
    if source == "fifo":
        with feed_fifo(str(d / "c2s.fifo"), c2s) as path:
            server_jpeg.main(["-i", path, "-c", s2c, "--device", "cpu"] + keys)
    else:
        subprocess.run([sys.executable, "-m", "fhetpu_torch.cli.server_jpeg", "-i",
                        "/dev/stdin", "-c", s2c, "--device", "cpu"] + keys,
                       input=c2s, cwd=REPO, check=True, timeout=300, capture_output=True)
    with open(s2c, "rb") as f:
        assert f.read() == want
