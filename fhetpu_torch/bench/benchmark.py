"""Sweep runner: runs client -> server -> client over the reference grid
POLY_N x PLAIN_MODS (benchmark/benchmark.py:5-9), one log file per
configuration, scraping the per-op CSV rows the CLIs print
(Encryption,/Decryption,/DCT,/Linear,/Cubic,/RMSError,).

Port of ``fhetpu/bench/benchmark.py``, with the same grid, flags, log names
and ``aggregate`` schema, so both packages' ``results_parser`` read either
output:

* all four ring degrees x all nine plain moduli, dbc fixed at one value
  (the reference parses dbc but never builds evaluation keys, SURVEY 2.4);
* servers run with --no-noise-check so the pass/fail RMS frontier emerges
  from the actual computation, exactly like the reference (whose only
  failure signal is the post-hoc RMS, results.txt:38 vs :382);
* the image scales with the ring degree (``IMG_PER_N``): the
  one-ciphertext-per-coefficient protocol moves 2 x (W*H*3) * 2*L*n*4
  bytes per config through the streams, and the servers' stream reads,
  pageable copies and writes take most of every CLI's wall time on the
  card (PERF.md section 5): 48x48 jpg at n=16384 streams 13.6 GB each
  way (6,912 ciphertexts of 2*15*16384*4 bytes).
  The frontier itself is ring-degree-invariant in the reference
  (identical RMS at every n, results.txt:45,39,99,51);
* bicubic runs the encrypted-fract ct*ct path at all four ring degrees on
  the same image ladder, its tile bounded by ``BICUBIC_TILES``.

Two differences from fhetpu's, because the GPU host has no PIL, no JAX and
no reference image:

* the image is a seeded NumPy array of ``IMG_PER_N``'s size, unless
  ``--image`` names a file (which needs PIL);
* the client halves run in this process (``client_{jpeg,resize}.send_array``
  and ``recieve_arrays``), their ``Encryption,``/``Decryption,`` rows and an
  ``RMSError,`` row written into the config's log; the JPEG receive is the
  client CLI's own ``run_recieve``, given the image array.

The server still runs as a subprocess (``python -m
fhetpu_torch.cli.server_* --device cuda --no-noise-check``) under the stage
timeout (``FHETPU_BENCH_STAGE_TIMEOUT``, default 900 s).

Usage: python -m fhetpu_torch.bench.benchmark [--out LOGDIR] [--quick]
       [--pipelines jpg,bilinear,bicubic] [--ns 2048,4096,8192,16384]
       [--pmods ...] [--device cuda] [--image FILE]
Writes per-config logs plus an aggregated grid_results.{json,txt}
under --out; exits 1 when a configuration failed.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import traceback

import numpy as np

# the reference's grid (benchmark/benchmark.py:5-9)
POLY_N = [2048, 4096, 8192, 16384]
PLAIN_MODS = [11, 31, 101, 307, 1009, 3001, 10007, 30011, 100003]
DBC = 30  # parsed-but-unused in the reference (fhe_image.h:28)
# ring degree -> (source image size, resize target); see module docstring
IMG_PER_N = {2048: (48, 17), 4096: (16, 8), 8192: (8, 4), 16384: (8, 4)}
# output rows x columns per bicubic server tile: bounds the unrelinearized
# size-8 tensor product's live device memory
BICUBIC_TILES = {2048: (2, 8), 4096: (2, 8), 8192: (1, 4), 16384: (1, 4)}
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run(cmd, log, env=None, timeout=None):
    """Run a stage as a subprocess, its output appended to ``log``; 124 when
    it outlives the stage timeout."""
    if timeout is None:
        timeout = int(os.environ.get("FHETPU_BENCH_STAGE_TIMEOUT", 900))
    with open(log, "a") as f:
        f.write("$ " + " ".join(cmd) + "\n")
        f.flush()
        try:
            r = subprocess.run(cmd, stdout=f, stderr=subprocess.STDOUT,
                               env=env, timeout=timeout)
        except subprocess.TimeoutExpired:
            f.write(f"\n[stage timed out after {timeout}s -- killed]\n")
            return 124
    return r.returncode


def run_here(what: str, fn, log) -> int:
    """Run a client half in this process with its stdout and stderr in
    ``log``; 1 (and the traceback in the log) when it raises, so the sweep
    goes on."""
    with open(log, "a") as f:
        f.write(f"$ {what} (in process)\n")
        f.flush()
        with contextlib.redirect_stdout(f), contextlib.redirect_stderr(f):
            try:
                fn()
            except Exception:  # one failed config must not end the sweep
                traceback.print_exc()
                return 1
    return 0


def server_env() -> dict:
    """The environment of a server subprocess: this one, with the package
    importable from any working directory."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (_ROOT, env.get("PYTHONPATH")) if p)
    return env


def source_image(size: int, path: str = "") -> np.ndarray:
    """uint8 [size, size, 3]: ``path`` resized (PIL), else seeded noise."""
    if path:
        from PIL import Image

        return np.asarray(Image.open(path).convert("RGB").resize((size, size)),
                          dtype=np.uint8)
    return np.random.default_rng(size).integers(0, 256, size=(size, size, 3),
                                                dtype=np.uint8)


def save_image(path_stem: str, pix: np.ndarray) -> str:
    """``pix`` as PNG where PIL exists, else as .npy; returns the path."""
    from ..io import images

    try:
        images.save_rgb(path_stem + ".png", pix)
        return path_stem + ".png"
    except ImportError:
        np.save(path_stem + ".npy", pix)
        return path_stem + ".npy"


def _recieve_resize(args, img):
    from ..cli import client_resize
    from ..io import images
    from ..pipelines.cv_resize import cv_ground_truth

    vals, _ = client_resize.recieve_arrays(args)
    pix = client_resize.to_pixels(vals)
    gt = cv_ground_truth(img, args.width, args.height, args.bicubic)
    print(f"RMSError,{images.rms_error(pix, gt):.6g},")
    save_image(os.path.splitext(args.outfile)[0], pix)


def call_pipeline(kind, n, pmod, logdir, workdir, device, img, img_tag=None):
    """One configuration: client send (in process), server (subprocess),
    client receive (in process), all logged to
    ``<kind>_<img_tag>_<n>_<pmod>_<DBC>.txt``.  Returns (rc, log)."""
    from ..cli import client_jpeg, client_resize

    dst_size = IMG_PER_N[n][1]
    img_tag = img_tag or f"rand{img.shape[0]}"
    log = os.path.join(logdir, f"{kind}_{img_tag}_{n}_{pmod}_{DBC}.txt")
    open(log, "w").close()
    keydir = os.path.join(workdir, "keys")
    c2s = os.path.join(workdir, "c2s.bin")
    s2c = os.path.join(workdir, "s2c.bin")
    out = os.path.join(workdir, f"out_{kind}.png" if kind != "jpg" else "out.jpg")
    common = ["--cmod", str(n), "--pmod", str(pmod), "--keydir", keydir]
    if kind == "jpg":
        client, server = client_jpeg, "fhetpu_torch.cli.server_jpeg"
        client_extra, server_extra = [], []
        recieve = client_jpeg.run_recieve
    else:
        client, server = client_resize, "fhetpu_torch.cli.server_resize"
        size = ["--width", str(dst_size), "--height", str(dst_size)]
        client_extra = size + ["--dbc", str(DBC)] + (["--bicubic"] if kind == "bicubic" else [])
        tr, tc = BICUBIC_TILES.get(n, (2, 8))
        server_extra = client_extra + (
            ["--tile-rows", str(tr), "--tile-cols", str(tc)] if kind == "bicubic" else [])
        recieve = _recieve_resize
    sargs = client.parser().parse_args(["--send", "-c", c2s] + common + client_extra)
    rc = run_here(f"{client.__name__}.send_array {' '.join(common + client_extra)}",
                  lambda: client.send_array(sargs, img), log)
    if rc == 0:
        # --no-noise-check: let the frontier emerge from the computation
        rc = run([sys.executable, "-m", server, "-i", c2s, "-c", s2c, "--keydir", keydir,
                  "--no-noise-check", "--device", device] + server_extra, log, server_env())
    if rc == 0:
        rargs = client.parser().parse_args(["--recieve", "-i", s2c, "-o", out] + common
                                           + client_extra)
        rc = run_here(f"{client.__name__}.recieve_arrays {' '.join(common + client_extra)}",
                      lambda: recieve(rargs, img), log)
    return rc, log


def aggregate(logdir: str, outdir: str):
    """Scrape every per-config log into grid_results.{json,txt} -- the
    analog of the reference's committed benchmark/results.txt."""
    from .analyze import parse_log

    rows = []
    for fname in sorted(os.listdir(logdir)):
        if not fname.endswith(".txt"):
            continue
        stem = fname[:-4].split("_")
        if len(stem) < 5:
            continue
        kind, img, n, pmod, dbc = stem[0], stem[1], stem[2], stem[3], stem[4]
        ops = {}
        for label, vals in parse_log(os.path.join(logdir, fname)).items():
            mean = sum(vals) / len(vals)
            var = sum((v - mean) ** 2 for v in vals) / len(vals)
            med = sorted(vals)[len(vals) // 2]
            ops[label] = {"mean_ms": round(mean, 4),
                          "median_ms": round(med, 4),
                          "std": round(var ** 0.5, 4), "count": len(vals)}
        rows.append({"pipeline": kind, "image": img, "n": int(n),
                     "pmod": int(pmod), "dbc": int(dbc), "ops": ops,
                     "rms": ops.get("RMSError", {}).get("mean_ms")})
    with open(os.path.join(outdir, "grid_results.json"), "w") as f:
        json.dump(rows, f, indent=1)
    lines = ["# fhetpu_torch reference-grid sweep (see fhetpu_torch/bench/benchmark.py "
             "docstring for grid shape)", ""]
    for r in rows:
        lines.append(f"{r['pipeline']} {r['image']} n={r['n']} "
                     f"pmod={r['pmod']} dbc={r['dbc']}")
        for label, s in r["ops"].items():
            lines.append(f"  {label},{s['mean_ms']},{s['std']},"
                         f"median={s['median_ms']},n={s['count']}")
        lines.append("")
    with open(os.path.join(outdir, "grid_results.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    return rows


def main(argv=None) -> int:
    from ..cli.common import device_or_exit

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="./benchlogs_torch")
    ap.add_argument("--workdir", default="./benchwork_torch")
    ap.add_argument("--quick", action="store_true",
                    help="single config per pipeline (smoke)")
    ap.add_argument("--pipelines", default="jpg,bilinear,bicubic")
    ap.add_argument("--ns", default=",".join(str(n) for n in POLY_N))
    ap.add_argument("--pmods", default=",".join(str(t) for t in PLAIN_MODS))
    ap.add_argument("--device", default="cuda", help="the servers' --device")
    ap.add_argument("--image", default="",
                    help="source image file (needs PIL); default: seeded noise")
    args = ap.parse_args(argv)
    device_or_exit(args.device)
    os.makedirs(args.out, exist_ok=True)
    os.makedirs(args.workdir, exist_ok=True)
    ns = [int(s) for s in args.ns.split(",")]
    pmods = [int(s) for s in args.pmods.split(",")]
    if args.quick:
        ns, pmods = [4096], [1 << 14]
    failed = 0
    for kind in args.pipelines.split(","):
        for n in ns:
            size = IMG_PER_N[n][0]
            img = source_image(size, args.image)
            tag = f"img{size}" if args.image else None
            for pmod in pmods:
                print(f"[{kind}] n={n} pmod={pmod}", flush=True)
                rc, log = call_pipeline(kind, n, pmod, args.out, args.workdir,
                                        args.device, img, tag)
                if rc:
                    failed += 1
                    print(f"  FAILED rc={rc} ({log})", flush=True)
                # checkpoint the aggregate after every config
                aggregate(args.out, args.out)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
