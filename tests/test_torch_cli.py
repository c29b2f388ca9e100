"""fhetpu_torch's CLI protocol against fhetpu's, for the JPEG and the
resize pipelines: fhetpu's client around the port's server, the port's own
client around it, the servers' refusal to fall back to the CPU,
chip_smoke.py's refusal without a GPU, and the package's independence from
JAX and from fhetpu.  Decrypted outputs must equal the golden oracle
exactly."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from fhetpu.bfv import crypto as f_crypto
from fhetpu.bfv.encoder import FractionalEncoder
from fhetpu.bfv.golden import GoldenEvaluator
from fhetpu.bfv.params import BfvParams as FBfvParams
from fhetpu.io import images
from fhetpu.io import serial as f_serial

from fhetpu_torch.bfv.encoder import FractionalEncoder as TFractionalEncoder
from fhetpu_torch.cli import client_jpeg, client_resize, server_jpeg, server_resize
from fhetpu_torch.pipelines import jpeg_encode as pipe
from fhetpu_torch.pipelines import resize as rz
from test_torch_resize import golden_resize

torch.set_num_threads(2)

N, T = 2048, 1 << 14
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def image():
    return np.random.default_rng(21).integers(0, 256, size=(8, 16, 3), dtype=np.uint8)


def _golden(img):
    """[nb, 3, 64, n] plaintext coefficients of the YCC+DCT network."""
    encoder = FractionalEncoder(T, N)
    blocks = np.stack([images.split_blocks(img[..., c].astype(np.float64))
                       for c in range(3)], axis=1)
    coeffs = encoder.encode_batch(blocks)
    gev = GoldenEvaluator(encoder)
    ycc = pipe.rgb_to_ycc(gev, coeffs[:, 0], coeffs[:, 1], coeffs[:, 2])
    return np.stack([np.stack(pipe.dct8x8(gev, [ch[:, k] for k in range(64)]), axis=1)
                     for ch in ycc], axis=1)


RESIZE_N = 4096  # the client's chooser for bilinear with encrypted fracts


def _rms_line(out: str) -> str:
    lines = [ln for ln in out.splitlines() if ln.startswith("RMSError,")]
    assert len(lines) == 1, out
    return lines[0]


def test_fhetpu_client_around_port_server(tmp_path, image, capsys):
    """fhetpu client --send -> fhetpu_torch server --device cpu -> fhetpu
    client --recieve: the stream decrypts to the golden oracle exactly."""
    from fhetpu.cli import client_jpeg as f_client

    d = str(tmp_path)
    img_path = os.path.join(d, "in.png")
    images.save_rgb(img_path, image)
    keys = os.path.join(d, "keys")
    common = ["--keydir", keys, "--chunk-blocks", "1"]
    c2s, s2c = os.path.join(d, "c2s.bin"), os.path.join(d, "s2c.bin")
    f_client.main(["--send", "-f", img_path, "-c", c2s, "--cmod", str(N),
                   "--pmod", str(T)] + common)
    server_jpeg.main(["-i", c2s, "-c", s2c, "--device", "cpu"] + common)
    f_client.main(["--recieve", "-f", img_path, "-i", s2c,
                   "-o", os.path.join(d, "out.jpg")] + common)
    out = capsys.readouterr().out
    assert out.splitlines()[1].startswith("DCT,")
    assert np.isfinite(float(_rms_line(out).split(",")[1]))

    reader = f_serial.CtReader(s2c)
    assert (reader.count, reader.meta["layout"], reader.meta["ntt"]) == (2 * 192, "ycc-blocks", False)
    cts = reader.read(2 * 192)
    reader.close()
    par = FBfvParams.create(n=N, t=T)
    sk = f_crypto.SecretKey(small=f_serial.load_secret_key(os.path.join(keys, "seckey.npz")),
                            params=par)
    got = f_crypto.Decryptor(par, sk).decrypt_batch(cts).reshape(2, 3, 64, N)
    assert np.array_equal(got, _golden(image))


@pytest.mark.parametrize("ntt_form", [False, True])
def test_port_client_around_port_server(tmp_path, image, capsys, ntt_form):
    """The port's own client around its server, in coefficient form and in
    NTT form: decrypts to the golden oracle, and the JPEG's RMS equals the
    one fhetpu's client reports for the same image."""
    d = str(tmp_path)
    img_path = os.path.join(d, "in.png")
    images.save_rgb(img_path, image)
    common = ["--keydir", os.path.join(d, "keys"), "--cmod", str(N), "--pmod", str(T)]
    c2s, s2c = os.path.join(d, "c2s.bin"), os.path.join(d, "s2c.bin")
    send = ["--send", "-f", img_path, "-c", c2s] + (["--ntt-form"] if ntt_form else [])
    client_jpeg.main(send + common)
    server_jpeg.main(["-i", c2s, "-c", s2c, "--device", "cpu"] + common)
    client_jpeg.main(["--recieve", "-f", img_path, "-i", s2c,
                      "-o", os.path.join(d, "out.jpg")] + common)
    ours = _rms_line(capsys.readouterr().out)

    args = client_jpeg.parser().parse_args(["--recieve", "-i", s2c] + common)
    vals, plain = client_jpeg.recieve_arrays(args, keep_plain=True)
    assert vals.shape == (2, 3, 64) and np.isfinite(vals).all()
    assert np.array_equal(plain, _golden(image))

    from fhetpu.cli import client_jpeg as f_client

    f_client.main(["--recieve", "-f", img_path, "-i", s2c,
                   "-o", os.path.join(d, "ref.jpg")] + common)
    assert _rms_line(capsys.readouterr().out) == ours


def test_server_refuses_missing_cuda(tmp_path, image, monkeypatch):
    """The default --device cuda never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    d = str(tmp_path)
    common = ["--keydir", os.path.join(d, "keys"), "--cmod", str(N), "--pmod", str(T)]
    c2s = os.path.join(d, "c2s.bin")
    client_jpeg.send_array(client_jpeg.parser().parse_args(["--send", "-c", c2s] + common),
                           image)
    with pytest.raises(SystemExit, match="no CUDA device"):
        server_jpeg.main(["-i", c2s, "-c", os.path.join(d, "s2c.bin")] + common)


_IMPORT_ALL = """
import importlib, pkgutil, sys
sys.modules["jax"] = None  # any import of jax now raises ImportError
import fhetpu_torch
names = [m.name for m in pkgutil.walk_packages(fhetpu_torch.__path__, "fhetpu_torch.")]
for name in names:
    importlib.import_module(name)
    print(name)
shared = set()  # the port keeps its own copies of fhetpu's JAX-free modules
loaded = {m for m in sys.modules if m == "fhetpu" or m.startswith("fhetpu.")}
assert loaded <= shared, sorted(loaded - shared)
assert not any(m.startswith("jax") and sys.modules[m] is not None for m in sys.modules)
print(len(names))
"""


def test_package_imports_without_jax():
    r = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    names = r.stdout.split()
    assert int(names[-1]) == len(names) - 1 >= 34
    for mod in ("bfv.rns", "pipelines.resize", "pipelines.cv_resize", "cli.client_resize",
                "cli.server_resize"):
        assert "fhetpu_torch." + mod in names


_RUN_SMOKE = """
import runpy, sys, torch

def run(path):
    try:
        runpy.run_path(path, run_name="__main__")
    except SystemExit as e:
        return e.code
    except ImportError as e:
        return type(e).__name__ + ": " + str(e)
    return 0

print("no-gpu", run(sys.argv[1]))
torch.cuda.is_available = lambda: True  # a card, but no repo beside the script
print("no-repo", run(sys.argv[2]))
"""


def test_chip_smoke_fails_without_gpu_or_repo(tmp_path):
    """chip_smoke.py exits non-zero and prints no result without a CUDA
    device, and, with a device, in a directory holding nothing else of the
    repo."""
    lone = tmp_path / "chip_smoke.py"
    with open(os.path.join(REPO, "chip_smoke.py")) as src:
        lone.write_text(src.read())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", _RUN_SMOKE, os.path.join(REPO, "chip_smoke.py"),
                        str(lone)], cwd=str(tmp_path), env=env, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "no CUDA device" in r.stderr
    assert r.stdout.splitlines() == [
        "no-gpu 2", "no-repo ModuleNotFoundError: No module named 'fhetpu_torch'"]


def _resize_stream(d, image, client_main, extra=()):
    """Write the image as a PNG and send it with a resize client (bilinear,
    6x6 -> 3x3); returns (png path, keydir, c2s path)."""
    img_path = os.path.join(d, "in.png")
    images.save_rgb(img_path, image)
    keys, c2s = os.path.join(d, "keys"), os.path.join(d, "c2s.bin")
    client_main(["--send", "-f", img_path, "-c", c2s, "--keydir", keys, "--width", "3",
                 "--height", "3"] + list(extra))
    return img_path, keys, c2s


def _resize_golden(img):
    encoder = TFractionalEncoder(T, RESIZE_N)
    coeffs = encoder.encode_batch(img.astype(np.float64))
    return golden_resize(encoder, coeffs, 3, 3, rz.BILINEAR)


@pytest.fixture(scope="module")
def resize_image():
    return np.random.default_rng(23).integers(0, 256, size=(6, 6, 3), dtype=np.uint8)


def test_fhetpu_resize_client_around_port_server(tmp_path, resize_image, capsys):
    """fhetpu client_resize --send (the chooser picks n=4096) -> the port's
    server_resize --device cpu (encrypted fracts, ct x ct, size 4) ->
    fhetpu client_resize --recieve: the stream decrypts to the golden
    network exactly and the client prints its RMS line."""
    from fhetpu.cli import client_resize as f_client

    d = str(tmp_path)
    img_path, keys, c2s = _resize_stream(d, resize_image, f_client.main)
    s2c = os.path.join(d, "s2c.bin")
    common = ["--keydir", keys, "--width", "3", "--height", "3"]
    server_resize.main(["-i", c2s, "-c", s2c, "--device", "cpu"] + common)
    f_client.main(["--recieve", "-f", img_path, "-i", s2c, "-o", os.path.join(d, "out.png")]
                  + common)
    out = capsys.readouterr().out
    assert any(ln.startswith("Linear,") for ln in out.splitlines())
    assert np.isfinite(float(_rms_line(out).split(",")[1]))
    reader = f_serial.CtReader(s2c)
    assert (reader.count, reader.size, reader.n, reader.meta["layout"]) == (27, 4, RESIZE_N,
                                                                            "raster-rgb")
    cts = reader.read(27)
    reader.close()
    par = FBfvParams.create(n=RESIZE_N, t=T)
    sk = f_crypto.SecretKey(small=f_serial.load_secret_key(os.path.join(keys, "seckey.npz")),
                            params=par)
    got = f_crypto.Decryptor(par, sk).decrypt_batch(cts).reshape(3, 3, 3, RESIZE_N)
    assert np.array_equal(got, _resize_golden(resize_image))


def test_port_resize_client_around_port_server_relin(tmp_path, resize_image, capsys):
    """The port's client on both sides with --relin (evaluation keys at
    dbc 30, every ct x ct relinearized, size 2 out): decrypts to the golden
    network, the decoded values are within 1e-5 of the float sampler, and
    fhetpu's client reads the same stream to the same RMS line."""
    d = str(tmp_path)
    img_path, keys, c2s = _resize_stream(d, resize_image, client_resize.main, ["--relin"])
    s2c = os.path.join(d, "s2c.bin")
    common = ["--keydir", keys, "--width", "3", "--height", "3"]
    server_resize.main(["-i", c2s, "-c", s2c, "--device", "cpu", "--relin"] + common)
    client_resize.main(["--recieve", "-f", img_path, "-i", s2c,
                        "-o", os.path.join(d, "out.png")] + common)
    ours = _rms_line(capsys.readouterr().out)
    args = client_resize.parser().parse_args(["--recieve", "-i", s2c] + common)
    vals, plain = client_resize.recieve_arrays(args, keep_plain=True)
    assert args.cmod == RESIZE_N and f_serial.CtReader(s2c).size == 2
    assert np.array_equal(plain, _resize_golden(resize_image))
    assert np.allclose(vals, rz.resize_float(resize_image, 3, 3, rz.BILINEAR), rtol=0, atol=1e-5)

    from fhetpu.cli import client_resize as f_client

    f_client.main(["--recieve", "-f", img_path, "-i", s2c, "-o", os.path.join(d, "ref.png")]
                  + common)
    assert _rms_line(capsys.readouterr().out) == ours


def test_resize_server_refuses_missing_cuda_and_sharded(tmp_path, monkeypatch):
    """The default --device cuda never falls back to the CPU, and
    --sharded, not ported, says where it is queued."""
    img = np.random.default_rng(3).integers(0, 256, size=(4, 4, 3), dtype=np.uint8)
    d = str(tmp_path)
    common = ["--keydir", os.path.join(d, "keys"), "--cmod", "2048", "--pmod", str(T),
              "--plain-fracts", "--width", "2", "--height", "2"]
    c2s = os.path.join(d, "c2s.bin")
    client_resize.send_array(client_resize.parser().parse_args(["--send", "-c", c2s] + common),
                             img)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        server_resize.main(["-i", c2s, "-c", os.path.join(d, "s2c.bin")] + common)
    with pytest.raises(SystemExit, match="queue 1 item 11"):
        server_resize.main(["-i", c2s, "-c", os.path.join(d, "s2c.bin"), "--sharded",
                            "--device", "cpu"] + common)


def test_resize_server_tiles_and_windows_give_one_stream(tmp_path):
    """The plain-fract path is deterministic, so every tiling gives the
    same stream: 12x12 -> 5x5 bilinear with the default tile and device
    window, with 1-row tiles of 2 columns (gap rows read and dropped, the
    window slid at every tile) and with 2-row tiles on a host window."""
    img = np.random.default_rng(5).integers(0, 256, size=(12, 12, 3), dtype=np.uint8)
    d = str(tmp_path)
    common = ["--keydir", os.path.join(d, "keys"), "--width", "5", "--height", "5",
              "--plain-fracts", "--device", "cpu"]
    c2s = os.path.join(d, "c2s.bin")
    client_resize.send_array(client_resize.parser().parse_args(
        ["--send", "-c", c2s, "--cmod", "2048"] + common[:-2]), img)
    streams = []
    for k, extra in enumerate(([], ["--tile-rows", "1", "--tile-cols", "2"],
                               ["--tile-rows", "2", "--host-window"])):
        s2c = os.path.join(d, f"s2c{k}.bin")
        server_resize.main(["-i", c2s, "-c", s2c] + common + extra)
        reader = f_serial.CtReader(s2c)
        streams.append(reader.read(75))
        reader.close()
    assert streams[0].shape == (75, 2, 2, 2048)
    for other in streams[1:]:
        assert np.array_equal(other, streams[0])
    args = client_resize.parser().parse_args(["--recieve", "-i", os.path.join(d, "s2c0.bin")]
                                             + common[:-2])
    vals, _ = client_resize.recieve_arrays(args)
    assert np.allclose(vals, rz.resize_float(img, 5, 5, rz.BILINEAR), rtol=0, atol=1e-5)


class _RowReader:
    """A stream of ciphertexts whose every residue is its source row index."""

    def __init__(self, h, w):
        self.cts = np.repeat(np.arange(h, dtype=np.uint32), w * 3 * 2 * 2 * 4).reshape(
            h * w * 3, 2, 2, 4)
        self.pos = 0

    def read(self, k):
        out = self.cts[self.pos:self.pos + k]
        self.pos += out.shape[0]
        return out if out.shape[0] else None


@pytest.mark.parametrize("on_host", [False, True], ids=["device", "host"])
def test_source_window_reads_every_row_once(on_host):
    """Row ranges that overlap (the window slides in place), leave gaps
    (read and dropped) and stay put: each advance returns exactly the
    asked rows, and the stream is read once, in order, to its end."""
    reader = _RowReader(12, 2)
    win = server_resize.SourceWindow(reader, 2, 2, 4, 4, torch.device("cpu"), on_host)
    for lo, hi in ((0, 3), (1, 4), (1, 4), (3, 5), (7, 9), (8, 12)):
        rows = win.advance(lo, hi)
        assert rows.shape == (hi - lo, 2, 3, 2, 2, 4)
        assert rows[:, 0, 0, 0, 0, 0].tolist() == list(range(lo, hi))
    assert reader.pos == reader.cts.shape[0]
    with pytest.raises(ValueError):
        win.advance(7, 12)
