"""fhetpu_torch's CLI protocol against fhetpu's: fhetpu's client around the
port's server, the port's own client around it, the server's refusal to
fall back to the CPU, chip_smoke.py's refusal without a GPU, and the
package's independence from JAX and from fhetpu.  Decrypted outputs must equal the golden
oracle exactly."""

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

from fhetpu_torch.cli import client_jpeg, server_jpeg
from fhetpu_torch.pipelines import jpeg_encode as pipe

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
    assert int(r.stdout.split()[-1]) >= 29


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
