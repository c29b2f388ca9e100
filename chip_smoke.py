#!/usr/bin/env python3
"""Smoke run of fhetpu_torch's main paths on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed on its own line; any failure exits non-zero:
  1. build the CUDA kernels from fhetpu_torch/csrc (one nvcc per source, in
     parallel), print each kernel's registers and shared memory
     (cuobjdump -res-usage), the NTT kernels' launch shape at each n
     (threads, ring bytes, CTAs per SM, registers, spills), the strict
     fused kernel's (threads, shared bytes, CTAs per SM, registers, spills)
     and the card;
  2. NTT and inverse-NTT kernels against their plain torch versions,
     bit-equal (tolerance 0), at n = 2048/4096/8192/16384 on the q and Bsk
     bases, at a batch of 301 and the ragged batches 1, 3 and 7;
     inverse(forward(x)) == x; forward == the host np_ntt;
  3. at the four ring degrees, nb = 2, on random residues and on every
     input at p - 1 (the largest intermediates), each bit-equal (tolerance
     0): the strict fused YCC+DCT kernel against its plain version; the lazy
     fused kernel against its plain version and the strict kernel at
     n = 2048/4096 (m = 2) and 8192 (m = 1), and its ValueError at 16384;
     the DCT-only kernel against its plain version;
  4. the main paths on a seeded 48x48 RGB image encrypted by the client
     (coefficient form, n chosen by the client: 4096), each driven with
     every launch count set to 0 just before it and read just after:
     a. the server CLI on the GPU; the decrypted coefficients must equal
        the plaintext golden oracle exactly and the decoded values must be
        within 1e-6 + 1e-7*|value| of the float AAN DCT (the bound of
        fhetpu's own pipeline test); both NTTs and the fused kernel launch;
     b. the server CLI with --quantize on the same stream: the DCT-only
        kernel and both NTTs launch, the fused kernel does not, and the
        decrypted coefficients equal the golden oracle's
        rgb_to_ycc -> dct8x8 -> quantize;
     c. the lazy server op (server_compute_fn(fused_lazy=True), NTT form in
        and out) on the same stream: the lazy kernel launches, and its
        output equals the strict op's and, after the inverse NTT, the
        stream of 4a;
     d-h. the resize main paths on the same image, 48x48 -> 17x17: the
        resize client sends it at the ring degree its chooser picks
        (bilinear n = 4096, bicubic n = 8192, the bicubic stream with
        evaluation keys at dbc 30), and server_resize --device cuda runs
        d. bilinear with encrypted fracts (ct x ct, unrelinearized),
        e. bilinear --plain-fracts on the same stream,
        f. bicubic with encrypted fracts (unrelinearized, size 8),
        g. bicubic --plain-fracts on the same stream,
        h. bicubic --relin;
        on each the NTT kernels launch and the JPEG kernels do not, the
        decoded values are within 1e-5 of resize_float, and the RMS against
        the cv ground truth and the peak device memory are printed; every
        path of a stream decrypts to the --plain-fracts path's polynomials
        exactly, and every output row to the golden network's;
     i-k. the decode main paths on the same image: i. harmonics (48x48,
        the chooser's n = 2048, order 64, degree 12) through
        client_decode -> server_decode --device cuda -> client_decode,
        both NTT kernels launched and no JPEG kernel, pixels within 1 of
        trunc+clamp of the exact series, channel 0's first 64 positions
        equal to expand_harmonics_server on the card and on the CPU;
        j. the trusted overload on a pair stream (n = 4096): host work
        only, no kernel launched, pixels within 1 of the series;
        k. pure-FHE: the library step of tests/test_decode.py's envelope
        (n = 8192, t = 2^24) on the card equal to the CPU's plain path and
        within 0.25 of the series, then the --pure-fhe CLI on a 4x4 image at
        n = 16384 with both NTT kernels on q and Bsk, pixels within 1;
  5. CUDA-event times of the whole server op, strict and --quantize, and of
     each kernel against its plain version at n=4096 and the CLI's 64-block
     chunk, beside each kernel's bound on this card; then per resize tile
     (4 rows x 17 columns, encrypted fracts) at n = 4096 bilinear and
     n = 8192 bicubic: CUDA-event ms, the host time of the fract operands,
     NTT launches per tile on q and Bsk, the NTT kernels' share of device
     time (torch.profiler), interps/s and peak device memory; then the
     decode harmonic expansion of one channel at 48x48 and n = 2048 (first
     call with the table build, the tables' NTT, calls from the cache, NTT
     launches per channel, NTT share, peak memory, bound from bytes) and
     ms per pure-FHE pair at n = 16384;
  6. the measurement layer, each entry point as its user calls it, with the
     launch counts set to 0 before each in-process one and read after:
     a. fhetpu_torch.bench.headline at n = 2048/4096/8192/16384 (its JSON
        line printed as it prints it, then each variant's samples); every
        variant runs but the lazy one at n = 16384, which is refused;
     b. fhetpu_torch.bench.noise_validation --from-artifact on all 66
        points of bench_results/noise_validation.json: every measured
        budget equal to the artifact's (tolerance 0), seconds per pipeline;
     c. fhetpu_torch.bench.benchmark --quick (jpg, bilinear, bicubic at
        n = 4096, t = 2^14, servers as subprocesses on the card): rc 0 and
        each config's op, Encryption, Decryption and RMSError rows parsed;
     d. fhetpu_torch.bench.decode_sweep --quick: rc 0, its rows parsed.

The last lines are a JSON object of the kernels, the card's name and power
limit from nvidia-smi, and {"ok": true, "device": {...}}.  Imports neither
JAX, nor PIL, nor anything of the fhetpu package.  Exits non-zero without a
CUDA device.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

SEED = 20261016
IMG_HW = 48  # the reference benchmark's image size (BASELINE.md)
DEGREES = (2048, 4096, 8192, 16384)
TIMING_N = 4096
TIMING_NB = 64  # the CLI's default --chunk-blocks
NTT_BATCH = 301  # more polynomials than one wave of the NTT's persistent grid
RAGGED = (1, 3, 7)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet

KERNELS = {
    "server_ycc_dct": ("fhetpu_torch/csrc/server_ycc_dct_strict.cu",
                       "fhetpu/core/pallas_server.py:237"),
    "ntt_forward": ("fhetpu_torch/csrc/ntt.cu", "fhetpu/core/pallas_ntt.py:98"),
    "ntt_inverse": ("fhetpu_torch/csrc/ntt.cu", "fhetpu/core/pallas_ntt.py:98"),
    "server_ycc_dct_lazy": ("fhetpu_torch/csrc/server_ycc_dct.cu",
                            "fhetpu/core/pallas_server.py:191"),
    "dct8x8": ("fhetpu_torch/csrc/dct.cu", "fhetpu/core/pallas_dct.py:161"),
}


def check(ok: bool, what: str):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def smi(query: str) -> str:
    r = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def resource_usage(lib_path: str) -> list:
    """'kernel REG:n SHARED:b' for each kernel in the built library, from
    cuobjdump; empty where the toolkit has no cuobjdump."""
    from fhetpu_torch.core import build

    tool = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return []
    r = subprocess.run([tool, "-res-usage", lib_path], capture_output=True, text=True,
                       timeout=120)
    out, name = [], None
    for line in r.stdout.splitlines():
        found = re.search(r"Function (\S+):", line)
        if found:
            short = re.search(r"(server_ycc_dct_strict_kernel|server_ycc_dct_lazy_kernelILi\d"
                              r"|dct8x8_kernel|ntt_kernelILb\dELi\d+)", found.group(1))
            name = short.group(1) if short else found.group(1)
        elif name and "REG:" in line:
            fields = dict(f.split(":", 1) for f in line.split() if ":" in f)
            out.append(f"{name} REG:{fields.get('REG')} SHARED:{fields.get('SHARED')}")
            name = None
    return out


def ntt_occupancy() -> list:
    """The NTT kernels' launch shape at each n, from fhetpu_ntt_occupancy:
    threads and ring bytes per CTA, resident CTAs per SM (so polynomials in
    flight per SM), registers and spilled bytes per thread."""
    import ctypes

    from fhetpu_torch.core import build

    fn = build.lib().fhetpu_ntt_occupancy
    fn.argtypes = [ctypes.c_int, ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 5
    fn.restype = ctypes.c_int
    out = []
    for n in DEGREES:
        for fwd in (1, 0):
            v = [ctypes.c_int() for _ in range(5)]
            build.check(fn(n, fwd, *v), "fhetpu_ntt_occupancy")
            threads, smem, per_sm, regs, local = (c.value for c in v)
            in_flight = per_sm * (smem - 4 * n)  # all of a CTA's ring but the current slot
            out.append(f"ntt_kernel {'forward' if fwd else 'inverse'} n={n}: {threads} threads, "
                       f"{smem} B ring, {per_sm} CTAs/SM ({in_flight} B in flight per SM), "
                       f"{regs} registers, {local} B local")
    return out


def server_occupancy() -> str:
    """The strict fused kernel's launch shape, from
    fhetpu_server_ycc_dct_occupancy: threads and static shared memory per
    CTA, resident CTAs (and warps) per SM, registers and spilled bytes per
    thread."""
    import ctypes

    from fhetpu_torch.core import build

    fn = build.lib().fhetpu_server_ycc_dct_occupancy
    fn.argtypes = [ctypes.POINTER(ctypes.c_int)] * 5
    fn.restype = ctypes.c_int
    v = [ctypes.c_int() for _ in range(5)]
    build.check(fn(*v), "fhetpu_server_ycc_dct_occupancy")
    threads, smem, per_sm, regs, local = (c.value for c in v)
    return (f"server_ycc_dct_strict_kernel: {threads} threads, {smem} B shared, {per_sm} CTAs/SM "
            f"({per_sm * threads // 32} warps), {regs} registers, {local} B local")


def counters() -> dict:
    """Each kernel's (wrapper, attribute) where the wrapper counts its
    launches; the fused wrapper counts its lazy kernel apart."""
    from fhetpu_torch.core import dct_kernel, ntt_kernel, server_kernel

    return {"server_ycc_dct": (server_kernel.server_ycc_dct_fused, "launches"),
            "ntt_forward": (ntt_kernel.ntt_forward, "launches"),
            "ntt_inverse": (ntt_kernel.ntt_inverse, "launches"),
            "server_ycc_dct_lazy": (server_kernel.server_ycc_dct_fused, "lazy_launches"),
            "dct8x8": (dct_kernel.dct8x8_kernel, "launches")}


def reset_launches():
    for w, attr in counters().values():
        setattr(w, attr, 0)


def read_launches() -> dict:
    return {name: getattr(w, attr) for name, (w, attr) in counters().items()}


def rand_residues(prefix, primes, n, gen, device):
    import torch

    p = torch.tensor(primes, dtype=torch.int64, device=device).reshape(-1, 1)
    x = torch.randint(0, 1 << 62, tuple(prefix) + (len(primes), n), generator=gen,
                      device=device, dtype=torch.int64)
    return (x % p).to(torch.uint32)


def max_abs_err(a, b) -> int:
    import torch

    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def phase_ntt(dev, gen, errs):
    import torch
    from fhetpu_torch.bfv.params import BfvParams
    from fhetpu_torch.core import ntt, ntt_kernel

    for n in DEGREES:
        par = BfvParams.create(n=n)
        for base, tables in (("q", par.tables_q), ("bsk", par.tables_bsk)):
            dt = ntt_kernel.device_tables(tables, dev)
            x = rand_residues((NTT_BATCH,), tables.primes, n, gen, dev)
            fk = ntt_kernel.ntt_forward(x, dt)
            ik = ntt_kernel.ntt_inverse(fk, dt)
            torch.cuda.synchronize()
            ef = max_abs_err(fk, ntt_kernel.ntt_plain(x, dt))
            ei = max_abs_err(ik, ntt_kernel.intt_plain(fk, dt))
            for b in RAGGED:  # batches smaller than the grid, each its own launch
                ef = max(ef, max_abs_err(ntt_kernel.ntt_forward(x[:b], dt), fk[:b]))
                ei = max(ei, max_abs_err(ntt_kernel.ntt_inverse(fk[:b], dt), ik[:b]))
            errs["ntt_forward"] = max(errs["ntt_forward"], ef)
            errs["ntt_inverse"] = max(errs["ntt_inverse"], ei)
            host = ntt.np_ntt(x[:8].cpu().numpy(), tables)
            check(ef == 0 and ei == 0, f"NTT kernels vs plain at n={n} {base}: {ef}, {ei}")
            check(max_abs_err(ik, x) == 0, f"inverse(forward(x)) != x at n={n} {base}")
            check(np.array_equal(fk[:8].cpu().numpy(), host),
                  f"NTT kernel vs np_ntt at n={n} {base}")
            print(f"phase 2: NTT n={n} {base} L={len(tables.primes)} B={NTT_BATCH} and "
                  f"B={RAGGED}: forward and inverse bit-equal to plain, roundtrip exact, "
                  "equal to np_ntt", flush=True)
            del x, fk, ik
        torch.cuda.empty_cache()


def worst_residues(prefix, primes, n, device):
    """Every residue at p - 1: the largest values each kernel's bounds
    must hold."""
    import torch

    top = torch.tensor(primes, dtype=torch.int64, device=device).reshape(-1, 1) - 1
    shape = tuple(prefix) + (len(primes), n)
    return top.expand(len(primes), n).to(torch.uint32).expand(shape).contiguous()


def phase_server(dev, gen, errs):
    import torch
    from fhetpu_torch.bfv.evaluator import Evaluator
    from fhetpu_torch.bfv.params import BfvParams
    from fhetpu_torch.core import dct_kernel, server_kernel

    for n in DEGREES:
        par = BfvParams.create(n=n)
        ev = Evaluator(par, device=dev)
        st = ev.server_state(dev)
        x = torch.cat([rand_residues((2, 3, 64, 2), par.q_primes, n, gen, dev),
                       worst_residues((1, 3, 64, 2), par.q_primes, n, dev)])
        strict = server_kernel.server_ycc_dct_fused(ev, x)
        torch.cuda.synchronize()
        e = max_abs_err(strict, server_kernel.server_ycc_dct_plain(x, st))
        errs["server_ycc_dct"] = max(errs["server_ycc_dct"], e)
        check(e == 0, f"fused kernel vs plain at n={n}: max abs err {e}")
        m = server_kernel.lazy_bound_multiple(ev)
        if m:
            lazy = server_kernel.server_ycc_dct_fused(ev, x, lazy=True)
            torch.cuda.synchronize()
            e = max_abs_err(lazy, server_kernel.server_ycc_dct_lazy_plain(x, st, m))
            errs["server_ycc_dct_lazy"] = max(errs["server_ycc_dct_lazy"], e)
            check(e == 0, f"lazy kernel vs plain at n={n} m={m}: max abs err {e}")
            check(max_abs_err(lazy, strict) == 0, f"lazy kernel vs strict kernel at n={n}")
            lazy_note = f"lazy (m={m}) bit-equal to its plain version and to strict"
        else:
            try:
                server_kernel.server_ycc_dct_fused(ev, x, lazy=True)
            except ValueError:
                lazy_note = "lazy refused with ValueError (no u32 headroom), as in fhetpu"
            else:
                raise RuntimeError(f"lazy kernel accepted n={n}, which has no headroom")
        check(n != 16384 or m == 0, "n=16384 must leave the lazy kernel no headroom")
        dct = dct_kernel.dct8x8_kernel(ev, x)
        torch.cuda.synchronize()
        e = max_abs_err(dct, dct_kernel.dct8x8_plain(x, st))
        errs["dct8x8"] = max(errs["dct8x8"], e)
        check(e == 0, f"DCT kernel vs plain at n={n}: max abs err {e}")
        print(f"phase 3: n={n} L={par.L} nb=2 random + 1 at p-1: fused YCC+DCT bit-equal "
              f"to plain; {lazy_note}; DCT-only bit-equal to plain", flush=True)
        del ev, st, x, strict, dct
        torch.cuda.empty_cache()


def _float_dct(block8):
    """The reference's plaintext double AAN DCT (fhe_image.h:399-484)."""
    d = block8.astype(np.float64).copy().reshape(8, 8)

    def pass1d(v):
        tmp0, tmp7 = v[0] + v[7], v[0] - v[7]
        tmp1, tmp6 = v[1] + v[6], v[1] - v[6]
        tmp2, tmp5 = v[2] + v[5], v[2] - v[5]
        tmp3, tmp4 = v[3] + v[4], v[3] - v[4]
        tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
        tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
        o = np.zeros(8)
        o[0], o[4] = tmp10 + tmp11, tmp10 - tmp11
        z1 = (tmp12 + tmp13) * 0.541196100
        o[2] = z1 + tmp13 * 0.765366865
        o[6] = z1 + tmp12 * -1.847759065
        z1, z2 = tmp4 + tmp7, tmp5 + tmp6
        z3, z4 = tmp4 + tmp6, tmp5 + tmp7
        z5 = (z3 + z4) * 1.175875602
        tmp4 *= 0.298631336
        tmp5 *= 2.053119869
        tmp6 *= 3.072711026
        tmp7 *= 1.501321110
        z1 *= -0.899976223
        z2 *= -2.562915447
        z3 = z3 * -1.961570560 + z5
        z4 = z4 * -0.390180644 + z5
        o[7] = tmp4 + z1 + z3
        o[5] = tmp5 + z2 + z4
        o[3] = tmp6 + z2 + z3
        o[1] = tmp7 + z1 + z4
        return o

    for r in range(8):
        d[r] = pass1d(d[r])
    for c in range(8):
        d[:, c] = pass1d(d[:, c]) / 8.0
    return d.reshape(64)


def _golden(encoder, img, quant=None):
    """[nb, 3, 64, n] plaintext coefficients of YCC -> DCT (-> quantize)."""
    from fhetpu_torch.bfv.golden import GoldenEvaluator
    from fhetpu_torch.io import images
    from fhetpu_torch.pipelines import jpeg_encode as pipe

    blocks = np.stack(
        [images.split_blocks(img[..., c].astype(np.float64)) for c in range(3)], axis=1)
    coeffs = encoder.encode_batch(blocks)  # [nb, 3, 64, n]
    gev = GoldenEvaluator(encoder)
    ycc = pipe.rgb_to_ycc(gev, coeffs[:, 0], coeffs[:, 1], coeffs[:, 2])
    outs = []
    for chan in ycc:
        slots = pipe.dct8x8(gev, [chan[:, k] for k in range(64)])
        if quant is not None:
            slots = pipe.quantize(gev, slots, quant)
        outs.append(np.stack(slots, axis=1))
    return np.stack(outs, axis=1)


def _read_stream(path, count):
    from fhetpu_torch.io import serial

    reader = serial.CtReader(path)
    try:
        cts = reader.read(count)
    finally:
        reader.close()
    check(cts is not None and cts.shape[0] == count, f"{path} holds fewer than {count} cts")
    return cts


def phase_main_paths(dev):
    import torch
    from fhetpu_torch.bfv.encoder import FractionalEncoder
    from fhetpu_torch.bfv.evaluator import Evaluator
    from fhetpu_torch.bfv.params import BfvParams
    from fhetpu_torch.cli import client_jpeg, server_jpeg
    from fhetpu_torch.codec.jpeg import ZIGZAG, build_quant_tables
    from fhetpu_torch.core import ntt
    from fhetpu_torch.core.server_kernel import lazy_bound_multiple
    from fhetpu_torch.io import images
    from fhetpu_torch.pipelines.jpeg_encode import server_compute_fn

    img = np.random.default_rng(SEED).integers(0, 256, size=(IMG_HW, IMG_HW, 3),
                                               dtype=np.uint8)
    nb = (IMG_HW // 8) ** 2
    launches = {}
    with tempfile.TemporaryDirectory() as d:
        common = ["--keydir", os.path.join(d, "keys")]
        c2s = os.path.join(d, "c2s.bin")
        sargs = client_jpeg.parser().parse_args(["--send", "-c", c2s] + common)
        t0 = time.perf_counter()
        client_jpeg.send_array(sargs, img)
        t_send = time.perf_counter() - t0
        check(sargs.cmod == 4096, f"client chose n={sargs.cmod}, expected 4096")
        encoder = FractionalEncoder(sargs.pmod, sargs.cmod)

        results = {}
        for label, path, extra in (("4a", "strict", []), ("4b", "quantize", ["--quantize"])):
            s2c = os.path.join(d, f"s2c_{path}.bin")
            reset_launches()
            t0 = time.perf_counter()
            server_jpeg.main(["-i", c2s, "-c", s2c, "--chunk-blocks", "64",
                              "--device", "cuda"] + extra + common)
            t_server = time.perf_counter() - t0
            launches[path] = read_launches()
            rargs = client_jpeg.parser().parse_args(["--recieve", "-i", s2c] + common)
            t0 = time.perf_counter()
            results[path] = client_jpeg.recieve_arrays(rargs, keep_plain=True)
            t_recv = time.perf_counter() - t0
            print(f"phase {label}: {path} path, 48x48 image, n={sargs.cmod}: "
                  f"client send {t_send:.3f} s, server CLI {t_server:.3f} s, client receive "
                  f"{t_recv:.3f} s (host clock); launches {launches[path]}", flush=True)

        # 4c: the lazy server op on the same ciphertexts, NTT form in and out
        par = BfvParams.create(n=sargs.cmod, t=sargs.pmod)
        ev = Evaluator(par, encoder, device=dev)
        shape = (nb, 3, 64, 2, par.L, par.n)
        x = torch.from_numpy(_read_stream(c2s, nb * 192).reshape(shape)).to(dev)
        x_ntt = ntt.ntt(x, par.tables_q)
        lazy_op = server_compute_fn(ev, input_ntt=True, output_ntt=True, fused_lazy=True)
        reset_launches()
        lazy_out = lazy_op(x_ntt)
        torch.cuda.synchronize()
        launches["lazy"] = read_launches()
        strict_out = server_compute_fn(ev, input_ntt=True, output_ntt=True)(x_ntt)
        check(max_abs_err(lazy_out, strict_out) == 0, "lazy server op differs from strict")
        cli_out = _read_stream(os.path.join(d, "s2c_strict.bin"), nb * 192).reshape(shape)
        check(np.array_equal(ntt.intt(lazy_out, par.tables_q).cpu().numpy(), cli_out),
              "lazy server op differs from the strict server CLI's stream")
    m = lazy_bound_multiple(ev)
    print(f"phase 4c: lazy server op, n={par.n} m={m}, on the image's {nb} blocks: bit-equal "
          f"to the strict op and to the server CLI's stream; launches {launches['lazy']}",
          flush=True)

    need = {"strict": ("ntt_forward", "server_ycc_dct", "ntt_inverse"),
            "quantize": ("ntt_forward", "dct8x8", "ntt_inverse"),
            "lazy": ("server_ycc_dct_lazy",)}
    for path, names in need.items():
        check(all(launches[path][k] > 0 for k in names),
              f"{path} path: a kernel of {names} never launched: {launches[path]}")
    check(launches["quantize"]["server_ycc_dct"] == 0, "--quantize ran the fused kernel")
    check(launches["lazy"]["server_ycc_dct"] == 0, "the lazy op ran the strict kernel")

    quant = build_quant_tables(0)[0][ZIGZAG].astype(np.float64)
    rf, gf, bf = (img[..., c].astype(np.float64) for c in range(3))
    chans = (0.299 * rf + 0.587 * gf + 0.114 * bf - 128.0,
             -0.168736 * rf - 0.331264 * gf + 0.5 * bf,
             0.5 * rf - 0.418688 * gf - 0.081312 * bf)
    # the bound of fhetpu's own test (assert_allclose with atol=1e-6 and
    # the default rtol=1e-7): at t=2^14 the exact mod-t network can wrap a
    # deep fractional digit, which the golden oracle reproduces bit for bit
    ref = np.stack([np.stack([_float_dct(b) for b in images.split_blocks(c)]) for c in chans],
                   axis=1)  # [nb, 3, 64]
    for path, q in (("strict", None), ("quantize", quant)):
        vals, plain = results[path]
        want = _golden(encoder, img, q)
        check(plain.shape == want.shape and np.array_equal(plain, want),
              f"{path} path: decrypted coefficients differ from the golden oracle")
        fref = ref if q is None else ref / q  # build_quant_tables(0) is all ones
        worst = float(np.abs(vals - fref).max())
        check(np.isfinite(vals).all() and np.allclose(vals, fref, rtol=1e-7, atol=1e-6),
              f"{path} path: decoded values off the float AAN DCT by up to {worst}")
        print(f"phase 4: {path} path: {plain.shape[0]} blocks decrypt to exactly the golden "
              f"oracle{'' if q is None else ' (rgb_to_ycc -> dct8x8 -> quantize)'}; decoded "
              f"values within 1e-6 + 1e-7*|ref| of the float AAN DCT (max abs diff "
              f"{worst:.3g})", flush=True)
    return {"server_ycc_dct": launches["strict"]["server_ycc_dct"],
            "ntt_forward": launches["strict"]["ntt_forward"],
            "ntt_inverse": launches["strict"]["ntt_inverse"],
            "server_ycc_dct_lazy": launches["lazy"]["server_ycc_dct_lazy"],
            "dct8x8": launches["quantize"]["dct8x8"]}


def _golden_resize_row(encoder, img, h2, w2, mode, y):
    """[W', 3, n] plaintext coefficients of output row y through the
    golden mod-t network, pixel by pixel (plain-fract semantics: the
    encrypted-fract path decrypts to the same polynomials)."""
    from types import SimpleNamespace

    from fhetpu_torch.bfv.golden import GoldenEvaluator
    from fhetpu_torch.pipelines import resize as rz

    gev = GoldenEvaluator(encoder)
    rp, cp = rz.axis_plan(img.shape[0], h2, mode), rz.axis_plan(img.shape[1], w2, mode)

    def fracts(f):
        t, omt, t2, t3 = (polys[0] if polys else None
                          for polys in rz.fract_polys(encoder, [f], mode))
        return SimpleNamespace(t=t, one_minus_t=omt, t2=t2, t3=t3)

    rows = {int(r): encoder.encode_batch(img[r].astype(np.float64)) for r in rp.idx[y]}
    fy = fracts(rp.fract[y])
    interp = rz.linear_interp if mode == rz.BILINEAR else rz.cubic_interp
    out = []
    for x in range(w2):
        fx = fracts(cp.fract[x])
        cols = [interp(gev, *[rows[int(r)][k] for k in cp.idx[x]], fx, True) for r in rp.idx[y]]
        out.append(interp(gev, *cols, fy, True))
    return np.stack(out)


RESIZE_HW = 17  # the reference benchmark's output size (BASELINE.md)
RESIZE_TIMING = (("bilinear", 4096), ("bicubic", 8192))  # the client's chooser's n


def phase_resize_paths(dev):
    """The resize main paths on the seeded 48x48 image, 48x48 -> 17x17:
    the client sends at the ring degree its chooser picks, then
    server_resize --device cuda runs each path with every launch count set
    to 0 just before it and read just after; the client decrypts."""
    import torch
    from fhetpu_torch.bfv.encoder import FractionalEncoder
    from fhetpu_torch.cli import client_resize, server_resize
    from fhetpu_torch.io import images
    from fhetpu_torch.pipelines import resize as rz
    from fhetpu_torch.pipelines.cv_resize import cv_ground_truth

    img = np.random.default_rng(SEED).integers(0, 256, size=(IMG_HW, IMG_HW, 3),
                                               dtype=np.uint8)
    size = ["--width", str(RESIZE_HW), "--height", str(RESIZE_HW)]
    step = 0
    for mode_name, mode, want_n in (("bilinear", rz.BILINEAR, 4096), ("bicubic", rz.BICUBIC, 8192)):
        flags = ["--bicubic"] if mode == rz.BICUBIC else []
        paths = [("default", []), ("plain-fracts", ["--plain-fracts"])]
        if mode == rz.BICUBIC:  # the one stream carries evaluation keys for --relin
            paths.append(("relin", ["--relin"]))
        with tempfile.TemporaryDirectory() as d:
            common = ["--keydir", os.path.join(d, "keys")] + size + flags
            c2s = os.path.join(d, "c2s.bin")
            sargs = client_resize.parser().parse_args(
                ["--send", "-c", c2s] + common + (["--relin"] if mode == rz.BICUBIC else []))
            t0 = time.perf_counter()
            client_resize.send_array(sargs, img)
            t_send = time.perf_counter() - t0
            check(sargs.cmod == want_n, f"{mode_name}: client chose n={sargs.cmod}, not {want_n}")
            encoder = FractionalEncoder(sargs.pmod, sargs.cmod)
            plains = {}
            for path, extra in paths:
                s2c = os.path.join(d, f"s2c_{path}.bin")
                reset_launches()
                torch.cuda.reset_peak_memory_stats(dev)
                t0 = time.perf_counter()
                server_resize.main(["-i", c2s, "-c", s2c, "--device", "cuda"] + extra + common)
                t_server = time.perf_counter() - t0
                got = read_launches()
                peak = torch.cuda.max_memory_allocated(dev)
                check(got["ntt_forward"] > 0 and got["ntt_inverse"] > 0,
                      f"{mode_name} {path}: the NTT kernels never launched: {got}")
                check(all(got[k] == 0 for k in ("server_ycc_dct", "server_ycc_dct_lazy",
                                                 "dct8x8")),
                      f"{mode_name} {path}: a JPEG kernel launched: {got}")
                rargs = client_resize.parser().parse_args(["--recieve", "-i", s2c] + common)
                t0 = time.perf_counter()
                vals, plains[path] = client_resize.recieve_arrays(rargs, keep_plain=True)
                t_recv = time.perf_counter() - t0
                os.remove(s2c)
                ref = rz.resize_float(img, RESIZE_HW, RESIZE_HW, mode)
                worst = float(np.abs(vals - ref).max())
                check(np.isfinite(vals).all() and worst <= 1e-5,
                      f"{mode_name} {path}: decoded values off resize_float by {worst}")
                gt = cv_ground_truth(img, RESIZE_HW, RESIZE_HW, mode == rz.BICUBIC)
                rms = images.rms_error(client_resize.to_pixels(vals), gt)
                step += 1
                print(f"phase 4{'defgh'[step - 1]}: resize {mode_name} {path}, {IMG_HW}x{IMG_HW} -> "
                      f"{RESIZE_HW}x{RESIZE_HW}, n={sargs.cmod}: client send "
                      f"{t_send:.3f} s, server CLI {t_server:.3f} s, client receive {t_recv:.3f} s "
                      f"(host clock); peak device memory {peak / 2**30:.3f} GiB; decoded values "
                      f"within {worst:.3g} of resize_float; RMSError,{rms:.6g}, against the cv "
                      f"ground truth; launches {got}", flush=True)
            for path in plains:
                check(np.array_equal(plains[path], plains["plain-fracts"]),
                      f"{mode_name} {path}: decrypted polynomials differ from --plain-fracts'")
            t0 = time.perf_counter()
            for y in range(RESIZE_HW):
                want = _golden_resize_row(encoder, img, RESIZE_HW, RESIZE_HW, mode, y)
                check(np.array_equal(plains["plain-fracts"][y], want),
                      f"{mode_name}: output row {y} differs from the golden network")
            print(f"phase 4: resize {mode_name}: every path ({', '.join(plains)}) decrypts to the "
                  f"same polynomials, and every output row to the golden network's "
                  f"({time.perf_counter() - t0:.1f} s on the host)", flush=True)


DECODE = {"order": 64, "degree": 12, "delta": 0.5}  # the reference's defaults
PURE_FHE = ["--cmod", "16384", "--pmod", str(1 << 24), "--fcoeff", "10", "--degree", "2"]


def series_oracle(img, order, degree, delta):
    """The exact Fourier series of each channel in doubles, [H, W, 3]: what
    every decode server mode reproduces (fhe_decode.h:244-282, regrouped by
    linearity into the channel harmonics)."""
    from fhetpu_torch.cli.client_decode import rle_encode
    from fhetpu_torch.pipelines.rle_decode import fourier_harmonics_host

    h0, w0 = img.shape[:2]
    pos = np.arange(h0 * w0, dtype=np.float64)
    out = np.zeros((h0 * w0, 3))
    for c in range(3):
        h = fourier_harmonics_host(rle_encode(img[..., c].reshape(-1)), order, degree, delta)
        vals = np.full(len(pos), h[0])
        for j in range(1, degree + 1):
            a_j = float(np.float32(j)) * np.pi / float(order)
            vals += h[j] * np.cos(a_j * pos) + h[degree + j] * np.sin(a_j * pos)
        out[:, c] = vals
    return out.reshape(h0, w0, 3)


def _decoded_within_one(pix, img, order, degree, delta, what):
    want = np.clip(np.trunc(series_oracle(img, order, degree, delta)), 0, 255)
    worst = float(np.abs(pix.astype(np.float64) - want).max())
    check(worst <= 1.0, f"{what}: pixels off trunc+clamp of the exact series by {worst}")
    return worst


def _count_ntt_by_base(fn, L):
    """Run fn, counting NTT kernel launches per (base, direction): the q
    base has L limbs, Bsk the others.  For this report only."""
    from fhetpu_torch.core import ntt_kernel

    bases, launch = {}, ntt_kernel._launch

    def counting(x, dt, forward):
        key = ("q" if dt.L == L else "Bsk", "forward" if forward else "inverse")
        bases[key] = bases.get(key, 0) + 1
        return launch(x, dt, forward)

    ntt_kernel._launch = counting
    try:
        out = fn()
    finally:
        ntt_kernel._launch = launch
    return out, bases


def phase_decode_paths(dev):
    """The decode main paths, each driven with every launch count set to 0
    just before it and read just after:
    4i. harmonics: the seeded 48x48 image through client_decode.send_array
        --harmonics (the chooser picks n), server_decode --device cuda and
        client_decode.recieve_arrays: both NTT kernels launch and no JPEG
        kernel; pixels within 1 of trunc+clamp of the exact series; channel
        0's first 64 positions equal expand_harmonics_server on the card
        and on the CPU's plain path, residue for residue;
    4j. trusted: the same image as a pair stream at n=4096 through the
        trusted server, which works on the host only: no kernel launches;
        pixels within 1 of the series;
    4k. pure-FHE: tests/test_decode.py's envelope call of
        approximated_step_fhe (n=8192, t=2^24, 10 digits, degree 2, 16
        positions) on the card equals the CPU's plain path residue for
        residue and decodes within 0.25 of the series; then the CLI
        (--pure-fhe, client --relin) on a 4x4 image of two runs per channel
        at n=16384: both NTT kernels launch on q and Bsk, pixels within 1
        of the series."""
    import torch
    from fhetpu_torch.bfv import crypto
    from fhetpu_torch.bfv.encoder import FractionalEncoder
    from fhetpu_torch.bfv.evaluator import Ct, Evaluator
    from fhetpu_torch.bfv.params import BfvParams
    from fhetpu_torch.cli import client_decode, server_decode
    from fhetpu_torch.io import serial
    from fhetpu_torch.pipelines import rle_decode as rd

    img = np.random.default_rng(SEED).integers(0, 256, size=(IMG_HW, IMG_HW, 3),
                                               dtype=np.uint8)
    jpeg_kernels = ("server_ycc_dct", "server_ycc_dct_lazy", "dct8x8")
    order, degree, delta = DECODE["order"], DECODE["degree"], DECODE["delta"]
    with tempfile.TemporaryDirectory() as d:
        common = ["--keydir", os.path.join(d, "keys")]
        c2s, s2c = os.path.join(d, "c2s.bin"), os.path.join(d, "s2c.bin")
        # 4i: harmonics
        sargs = client_decode.parser().parse_args(["--send", "-c", c2s, "--harmonics"] + common)
        t0 = time.perf_counter()
        client_decode.send_array(sargs, img)
        t_send = time.perf_counter() - t0
        check(sargs.cmod == 2048, f"harmonic client chose n={sargs.cmod}, expected 2048")
        reset_launches()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        server_decode.main(["-i", c2s, "-c", s2c, "--device", "cuda"] + common)
        t_server = time.perf_counter() - t0
        got = read_launches()
        peak = torch.cuda.max_memory_allocated(dev)
        check(got["ntt_forward"] > 0 and got["ntt_inverse"] > 0,
              f"decode harmonics: the NTT kernels never launched: {got}")
        check(all(got[k] == 0 for k in jpeg_kernels), f"decode harmonics: a JPEG kernel ran: {got}")
        rargs = client_decode.parser().parse_args(["--recieve", "-i", s2c] + common)
        t0 = time.perf_counter()
        vals = client_decode.recieve_arrays(rargs)
        t_recv = time.perf_counter() - t0
        worst = _decoded_within_one(client_decode.to_pixels(vals), img, order, degree, delta,
                                    "decode harmonics")
        par = BfvParams.create(n=sargs.cmod, t=sargs.pmod)
        encoder = FractionalEncoder(sargs.pmod, sargs.cmod)
        H, P = 2 * degree + 1, IMG_HW * IMG_HW
        harm = _read_stream(c2s, H)
        cli0 = _read_stream(s2c, 64)  # channel 0, positions 0..63, coefficient form
        for where in (dev, torch.device("cpu")):
            ev = Evaluator(par, encoder, device=where)
            out = rd.expand_harmonics_server(ev, Ct(torch.from_numpy(harm).to(where)),
                                             np.arange(64), order, degree)
            out = ev.transform_from_ntt(out).data.cpu().numpy()
            check(np.array_equal(out, cli0),
                  f"decode harmonics: channel 0 differs from expand_harmonics_server on {where}")
            del ev, out
        torch.cuda.empty_cache()
        print(f"phase 4i: decode harmonics, {IMG_HW}x{IMG_HW}, n={sargs.cmod} (chooser), "
              f"order {order}, degree {degree} ({H} harmonics x {P} positions x 3): client send "
              f"{t_send:.3f} s, server CLI {t_server:.3f} s, client receive {t_recv:.3f} s (host "
              f"clock); peak device memory {peak / 2**30:.3f} GiB; pixels within {worst:.0f} of "
              f"trunc+clamp of the exact series; channel 0's first 64 positions equal "
              f"expand_harmonics_server on the card and on the CPU; launches {got}", flush=True)

        # 4j: trusted, a pair stream at n=4096
        keys = os.path.join(d, "keys_pairs")
        common = ["--keydir", keys, "--cmod", "4096"]
        sargs = client_decode.parser().parse_args(["--send", "-c", c2s] + common)
        t0 = time.perf_counter()
        client_decode.send_array(sargs, img)
        t_send = time.perf_counter() - t0
        reset_launches()
        t0 = time.perf_counter()
        server_decode.main(["-i", c2s, "-c", s2c, "--device", "cuda", "--keydir", keys])
        t_server = time.perf_counter() - t0
        got = read_launches()
        check(all(v == 0 for v in got.values()), f"decode trusted launched a kernel: {got}")
        rargs = client_decode.parser().parse_args(["--recieve", "-i", s2c] + common)
        t0 = time.perf_counter()
        vals = client_decode.recieve_arrays(rargs)
        t_recv = time.perf_counter() - t0
        worst = _decoded_within_one(client_decode.to_pixels(vals), img, order, degree, delta,
                                    "decode trusted")
        npairs = list(serial.read_params_txt(os.path.join(keys, "params.txt"))[2:5])
        print(f"phase 4j: decode trusted, {IMG_HW}x{IMG_HW}, n=4096, {npairs} pairs per channel: "
              f"client send {t_send:.3f} s, server CLI {t_server:.3f} s (host work only: "
              f"decrypt, series in doubles, encrypt; the mode does no device work, launches "
              f"{got}), client receive {t_recv:.3f} s; pixels within {worst:.0f} of trunc+clamp "
              f"of the exact series", flush=True)

    # 4k: pure-FHE, the library call of tests/test_decode.py's envelope test
    n, t = 8192, 1 << 24
    par = BfvParams.create(n=n, t=t)
    kg = crypto.KeyGenerator(par, seed=SEED)
    enc = crypto.Encryptor(par, kg.public_key(), seed=SEED + 1)
    encoder = FractionalEncoder(t, n, 100, 10)
    val, cnt, index, positions = 50.0, 3.0, 2.0, np.arange(16)
    cts = [enc.encrypt(encoder.encode(v)) for v in (val, index, cnt)]
    outs = []
    for where in (dev, torch.device("cpu")):
        ev = Evaluator(par, encoder, device=where)
        reset_launches()
        t0 = time.perf_counter()
        amp, idx, c = (Ct(torch.from_numpy(x).to(where)) for x in cts)
        run, bases = _count_ntt_by_base(lambda: rd.approximated_step_fhe(
            ev, amp, idx, c, 64, 2, 0.5, positions, relin=None, taylor_max_power=3), par.L)
        run = ev.transform_from_ntt(run).data.to(torch.uint32).cpu().numpy()
        outs.append((run, time.perf_counter() - t0, read_launches(), bases))
        del ev
    torch.cuda.empty_cache()
    (run, t_gpu, got, bases), (cpu_run, t_cpu, _, _) = outs
    check(np.array_equal(run, cpu_run), "pure-FHE step on the card differs from the CPU's")
    check(all(bases.get((b, k), 0) > 0 for b in ("q", "Bsk") for k in ("forward", "inverse")),
          f"pure-FHE step: an NTT kernel missed a base: {bases}")
    dec = crypto.Decryptor(par, kg.secret)
    got_vals = encoder.decode_batch(dec.decrypt_batch(run))
    want = step_oracle(val, cnt, index, 64, 2, 0.5, positions)
    worst = float(np.abs(got_vals - want).max())
    check(worst <= 0.25, f"pure-FHE step off the series by {worst}")
    budget = int(dec.invariant_noise_budget(run[0]))
    check(budget > 0, "pure-FHE step: no noise budget left")
    print(f"phase 4k: pure-FHE step (library), n={n}, t=2^24, 10 digits, degree 2, 16 positions, "
          f"unrelinearized (size {run.shape[1]}): card {t_gpu:.3f} s, CPU plain path {t_cpu:.3f} s "
          f"(host clock), residue-equal; within {worst:.3g} of the series; noise budget "
          f"{budget} bits; NTT launches by base {sorted(bases.items())}", flush=True)

    # 4k: the pure-FHE CLI on a 4x4 image of two runs per channel
    small = np.zeros((4, 4, 3), dtype=np.uint8)
    small[:2], small[2:] = (20, 50, 5), (45, 12, 33)
    with tempfile.TemporaryDirectory() as d:
        common = ["--keydir", os.path.join(d, "keys")] + PURE_FHE
        c2s, s2c = os.path.join(d, "c2s.bin"), os.path.join(d, "s2c.bin")
        sargs = client_decode.parser().parse_args(["--send", "-c", c2s, "--relin"] + common)
        t0 = time.perf_counter()
        client_decode.send_array(sargs, small)
        t_send = time.perf_counter() - t0
        reset_launches()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        _, bases = _count_ntt_by_base(lambda: server_decode.main(
            ["-i", c2s, "-c", s2c, "--device", "cuda", "--pure-fhe"] + common),
            BfvParams.create(n=int(PURE_FHE[1])).L)
        t_server = time.perf_counter() - t0
        got = read_launches()
        peak = torch.cuda.max_memory_allocated(dev)
        check(all(bases.get((b, k), 0) > 0 for b in ("q", "Bsk") for k in ("forward", "inverse")),
              f"pure-FHE CLI: an NTT kernel missed a base: {bases}")
        check(all(got[k] == 0 for k in jpeg_kernels), f"pure-FHE CLI: a JPEG kernel ran: {got}")
        rargs = client_decode.parser().parse_args(["--recieve", "-i", s2c] + common)
        vals = client_decode.recieve_arrays(rargs)
        worst = _decoded_within_one(client_decode.to_pixels(vals), small, 64, 2, 0.5,
                                    "pure-FHE CLI")
        werr = float(np.abs(vals - series_oracle(small, 64, 2, 0.5)).max())
    print(f"phase 4k: pure-FHE CLI, 4x4, two runs per channel, n=16384, t=2^24, 10 digits, "
          f"degree 2, relinearized (dbc 0): client send {t_send:.3f} s, server CLI "
          f"{t_server:.3f} s (host clock); peak device memory {peak / 2**30:.3f} GiB; decoded "
          f"values within {werr:.3g} of the series, pixels within {worst:.0f} of trunc+clamp; "
          f"launches {got}, by base {sorted(bases.items())}", flush=True)


def step_oracle(val, cnt, index, order, degree, delta, positions):
    """The Fourier step of one pair in doubles (fhe_decode.h:244-282)."""
    b = cnt / 2.0
    offset = -(index + b - 0.5)
    b += delta - 0.5
    want = np.zeros(len(positions))
    for pi, i in enumerate(positions):
        res = b / order
        for j in range(1, degree + 1):
            a_j = float(np.float32(j)) * np.pi / order
            res += (2.0 / (np.pi * float(np.float32(j))) * np.cos(a_j * (i + offset))
                    * np.sin(a_j * b))
        want[pi] = res * val
    return want


def time_ms(fn, reps: int) -> float:
    import torch

    fn()  # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


# The operation bound counts the fewest int32 operations of an op graph that
# gives each kernel's output bits (the lazy graph where the primes leave
# headroom: the lazy fused kernel gives the strict one's bits, and a
# Harvey-style lazy butterfly the NTTs'), as (FMA-pipe, ALU-pipe, either)
# operations: NVIDIA's CUDA C++ Programming Guide gives compute capability
# 9.0 64 results per SM per clock for 32-bit integer add, multiply(-add),
# compare and min/max; Nsight Compute's pipe table puts IMAD/IMUL on the FMA
# pipe and compares, min/max and logic on the ALU pipe, and an add runs on
# either (IADD3 or IMAD.IADD).  Per modular operation:
LAZY_ADD = np.array([0, 0, 1])  # a + k*p - b, one three-input add
ADD = np.array([0, 1, 2])  # a + b and a + b - p, then their min
LAZY_MUL = np.array([3, 0, 0])  # Shoup: mulhi(x, w'), then x*w - q*p
MUL = LAZY_MUL + np.array([0, 1, 1])  # then a subtraction of p and a min
RED = np.array([0, 1, 1])  # one conditional subtraction: subtract, min
# one lazy 8-point AAN pass (28 three-input adds, 12 products) reduced to
# [0, m*p) by 3 subtractions after a row pass; a column pass adds the 8
# x0.125 products and reduces its outputs (< 2p) by one subtraction
LAZY_DCT = (8 * (28 * LAZY_ADD + 12 * LAZY_MUL + 8 * 3 * RED)
            + 8 * (28 * LAZY_ADD + 20 * LAZY_MUL + 8 * RED))
LANE_OPS_PER_CLOCK = np.array([64, 64])  # FMA pipe, ALU pipe, per SM
ISSUE_PER_CLOCK = 128  # 4 warp schedulers x 32 lanes, per SM


def _device_times(prof) -> tuple:
    """(NTT kernels' ms, all kernels' ms) of a torch.profiler run: device
    time summed over the CUDA events (the NTT kernels by their name)."""
    import torch

    ntt_us = all_us = 0.0
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        us = evt.self_cuda_time_total if us is None else us
        all_us += us
        ntt_us += us if "ntt_kernel" in evt.key else 0.0
    return ntt_us / 1e3, all_us / 1e3


def phase_resize_timing(dev, gen, card):
    """CUDA-event ms of one resize tile (4 output rows x 17 columns, the
    server's default tile, over a source window of random residues) for the
    bilinear (n=4096) and bicubic (n=8192) encrypted-fract ops, the host
    time of their fract operands, the NTT launches per tile on each base,
    the share of device time in the NTT kernels (torch.profiler), interps/s
    and peak device memory."""
    import torch
    from fhetpu_torch.bfv.crypto import Encryptor, KeyGenerator
    from fhetpu_torch.bfv.encoder import FractionalEncoder
    from fhetpu_torch.bfv.evaluator import Evaluator
    from fhetpu_torch.bfv.params import BfvParams
    from fhetpu_torch.cli.server_resize import tile_rows
    from fhetpu_torch.core import ntt_kernel
    from fhetpu_torch.pipelines import resize as rz

    for mode_name, n in RESIZE_TIMING:
        mode = rz.BICUBIC if mode_name == "bicubic" else rz.BILINEAR
        interp_per_px = 20 if mode == rz.BICUBIC else 3  # the server's OpTimer units
        par = BfvParams.create(n=n)
        ev = Evaluator(par, FractionalEncoder(par.t, n), device=dev)
        enc = Encryptor(par, KeyGenerator(par, seed=SEED).public_key(), seed=SEED)
        row_plan, col_plan = (rz.axis_plan(IMG_HW, RESIZE_HW, mode) for _ in range(2))
        y0, y1, lo, hi = tile_rows(row_plan, RESIZE_HW, 4)[1]
        win = rand_residues((hi - lo, IMG_HW, 3, 2), par.q_primes, n, gen, dev)
        rp = rz.AxisPlan(idx=row_plan.idx[y0:y1] - lo, fract=row_plan.fract[y0:y1])
        t0 = time.perf_counter()
        yops, xops = rz.make_fract_bundles(ev, rp, col_plan, mode, encryptor=enc)
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0

        def tile():
            return rz.resize_tile(ev, win, rp, col_plan, yops, xops, mode, False)

        bases = {}
        launch = ntt_kernel._launch

        def counting(x, dt, forward):  # launches per base, for this report only
            key = ("q" if dt.L == par.L else "Bsk", "forward" if forward else "inverse")
            bases[key] = bases.get(key, 0) + 1
            return launch(x, dt, forward)

        reset_launches()
        ntt_kernel._launch = counting
        try:
            tile()
        finally:
            ntt_kernel._launch = launch
        torch.cuda.synchronize()
        per_tile = read_launches()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        ms = time_ms(tile, 3)
        peak = torch.cuda.max_memory_allocated(dev)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            tile()
            torch.cuda.synchronize()
        ntt_ms, dev_ms = _device_times(prof)
        interps = (y1 - y0) * RESIZE_HW * interp_per_px
        share = (f"NTT kernels {ntt_ms:.3f} ms of {dev_ms:.3f} ms device time "
                 f"({100 * ntt_ms / dev_ms:.1f} %), torch int64 passes and copies the rest"
                 if dev_ms > 0 else "the profiler saw no device time: share not measured")
        print(f"phase 5: resize {mode_name} tile, n={n}, {y1 - y0} rows x {RESIZE_HW} columns x 3, "
              f"encrypted fracts, unrelinearized: {ms:.3f} ms per tile (CUDA events, 3 runs), "
              f"{interps / (ms / 1e3):.1f} interps/s; fract operands on the host {host_s:.3f} s; "
              f"NTT launches per tile {per_tile['ntt_forward']} forward, "
              f"{per_tile['ntt_inverse']} inverse, by base {sorted(bases.items())}; {share}; "
              f"peak device memory {peak / 2**30:.3f} GiB [{card}]", flush=True)
        del win, yops, xops, ev
        torch.cuda.empty_cache()


def phase_decode_timing(dev, card):
    """The harmonic expansion of one channel at 48x48 and the chooser's
    n=2048 (order 64, degree 12: 25 harmonics x 2304 positions): the first
    call, which builds the weight tables (host encoding, upload, lift and
    one forward NTT; host clock), the tables' NTT alone and later calls from
    the cache (CUDA events), NTT launches per channel, the NTT share of
    device time (torch.profiler), peak device memory and the bound from
    bytes; then CUDA-event ms per pure-FHE pair at n=16384 (16 positions,
    degree 2, relinearized)."""
    import torch
    from fhetpu_torch.bfv import crypto
    from fhetpu_torch.bfv.encoder import FractionalEncoder
    from fhetpu_torch.bfv.evaluator import Ct, DeviceRelinKeys, Evaluator
    from fhetpu_torch.bfv.params import BfvParams
    from fhetpu_torch.core import ntt
    from fhetpu_torch.pipelines import rle_decode as rd

    order, degree = DECODE["order"], DECODE["degree"]
    par = BfvParams.create(n=2048)
    encoder = FractionalEncoder(par.t, par.n)
    ev = Evaluator(par, encoder, device=dev)
    H, P = 2 * degree + 1, IMG_HW * IMG_HW
    positions = np.arange(P)
    kg = crypto.KeyGenerator(par, seed=SEED)
    harm_vals = np.random.default_rng(SEED).uniform(-3000.0, 3000.0, size=H)
    harm = Ct(torch.from_numpy(crypto.Encryptor(par, kg.public_key(), seed=SEED).encrypt_batch(
        encoder.encode_batch(harm_vals))).to(dev))

    def channel():
        return ev.transform_from_ntt(rd.expand_harmonics_batched(ev, harm, positions, order,
                                                                 degree))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    channel()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    tabs = rd.harmonic_weight_tables(ev, positions, order, degree)
    flat = tabs.reshape(-1, par.L, par.n)
    tab_ms = time_ms(lambda: ntt.ntt(flat, par.tables_q), 3)
    reset_launches()
    channel()
    torch.cuda.synchronize()
    per_channel = read_launches()
    ms = time_ms(lambda: rd.expand_harmonics_batched(ev, harm, positions, order, degree), 5)
    ms_io = time_ms(channel, 5)
    peak = torch.cuda.max_memory_allocated(dev)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        channel()
        torch.cuda.synchronize()
    ntt_ms, dev_ms = _device_times(prof)
    share = (f"NTT kernels {ntt_ms:.3f} ms of {dev_ms:.3f} ms device time "
             f"({100 * ntt_ms / dev_ms:.1f} %)" if dev_ms > 0
             else "the profiler saw no device time: share not measured")
    # bytes: the tables once, the harmonics once, the output once
    nbytes = tabs.numel() * 4 + harm.data.numel() * 4 + P * 2 * par.L * par.n * 4
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"phase 5: decode harmonic expansion, one channel, {IMG_HW}x{IMG_HW}, n={par.n}, "
          f"{H} harmonics x {P} positions: first call (builds the {tabs.numel() * 4 / 1e9:.3f} GB "
          f"weight tables: host encoding, upload, lift, one forward NTT over {H * P} rows) "
          f"{first_s:.3f} s host clock, of which the tables' NTT {tab_ms:.3f} ms (CUDA events); "
          f"from the cache {ms:.3f} ms per channel (CUDA events, 5 runs; the harmonics' forward "
          f"NTT included), {ms_io:.3f} ms with the output's inverse NTT, "
          f"{P * 1e3 / ms_io:.1f} output "
          f"positions x channels per s; NTT launches per channel {per_channel['ntt_forward']} "
          f"forward, {per_channel['ntt_inverse']} inverse; {share}; bound {bound_ms:.3f} ms by "
          f"bytes ({nbytes / 1e9:.3f} GB; {100 * bound_ms / ms_io:.1f} % of it reached); peak "
          f"device memory {peak / 2**30:.3f} GiB [{card}]", flush=True)
    del tabs, flat, ev, harm
    torch.cuda.empty_cache()

    n, t = 16384, 1 << 24
    par = BfvParams.create(n=n, t=t)
    encoder = FractionalEncoder(t, n, 100, 10)
    ev = Evaluator(par, encoder, device=dev)
    kg = crypto.KeyGenerator(par, seed=SEED)
    enc = crypto.Encryptor(par, kg.public_key(), seed=SEED + 1)
    rk = DeviceRelinKeys(kg.relin_keys(max_power=2, digit_bits=0))
    amp, idx, c = (Ct(torch.from_numpy(enc.encrypt(encoder.encode(v))).to(dev))
                   for v in (45.0, 8.0, 8.0))
    positions = np.arange(16)

    def pair():
        return rd.approximated_step_fhe(ev, amp, idx, c, 64, 2, 0.5, positions, rk)

    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    _, bases = _count_ntt_by_base(pair, par.L)
    torch.cuda.synchronize()
    ms = time_ms(pair, 3)
    peak = torch.cuda.max_memory_allocated(dev)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        pair()
        torch.cuda.synchronize()
    ntt_ms, dev_ms = _device_times(prof)
    share = (f"NTT kernels {ntt_ms:.3f} ms of {dev_ms:.3f} ms device time "
             f"({100 * ntt_ms / dev_ms:.1f} %)" if dev_ms > 0
             else "the profiler saw no device time: share not measured")
    print(f"phase 5: decode pure-FHE step, one pair, n={n}, t=2^24, degree 2, 16 positions, "
          f"relinearized (dbc 0): {ms:.3f} ms per pair (CUDA events, 3 runs); NTT launches per "
          f"pair by base {sorted(bases.items())}; {share}; peak device memory "
          f"{peak / 2**30:.3f} GiB [{card}]", flush=True)
    del ev, rk, amp, idx, c
    torch.cuda.empty_cache()


def kernel_work(name, x, L, n, m) -> tuple:
    """(bytes, [FMA, ALU, either] int32 operations) that kernel ``name``
    needs for input x: x read once and the output (x's size) written once,
    plus the table rows it reads; operations of the fewest-op graph above
    (the lazy graphs need m = lazy_bound_multiple > 0)."""
    assert m > 0, "the lazy op graphs need u32 headroom"
    xbytes = x.numel() * 4
    if name.startswith("ntt"):
        polys = x.numel() // n  # (poly, limb) pairs
        # butterfly: a lazy product, x + t, x - t + 2p, one subtraction
        fly = LAZY_MUL + 2 * LAZY_ADD + RED
        stages = n.bit_length() - 1
        if name == "ntt_forward":  # values < 4p; two subtractions at the end
            per = stages * (n // 2) * fly + n * 2 * RED
        else:  # n^-1 folded into the last stage's products; one subtraction
            last = 2 * LAZY_MUL + 2 * LAZY_ADD
            per = (stages - 1) * (n // 2) * fly + (n // 2) * last + n * RED
        return 2 * xbytes + 2 * L * n * 4, polys * per
    threads = x.numel() // 64  # one per (block, channel, component, lane)
    if name == "dct8x8":  # rows 0..12 and 22 of both tables
        return 2 * xbytes + 2 * 14 * L * n * 4, threads * LAZY_DCT
    # the fused kernels, one thread per (block, component, lane): per slot
    # 9 products, 6 three-input adds and 3 reductions from 8p to m*p
    steps = 3 if m == 1 else 2
    ycc = 64 * (9 * LAZY_MUL + 6 * LAZY_ADD + 3 * steps * RED)
    return 2 * xbytes + 2 * 24 * L * n * 4, threads // 3 * (ycc + 3 * LAZY_DCT)


def bound_times(nbytes, ops, sms, clock_hz) -> tuple:
    """(HBM ms, integer ms): the bytes over HBM's rate, and the least integer
    time, in which each pipe runs its own operations at its rate and all of
    them issue at the issue rate.  The bound is the larger."""
    clocks = max(*(ops[:2] / LANE_OPS_PER_CLOCK), ops.sum() / ISSUE_PER_CLOCK)
    return nbytes / HBM_BYTES_PER_S * 1e3, clocks / (sms * clock_hz) * 1e3


def phase_timing(dev, gen, errs, card):
    import torch
    from fhetpu_torch.bfv.evaluator import Evaluator
    from fhetpu_torch.bfv.params import BfvParams
    from fhetpu_torch.codec.jpeg import ZIGZAG, build_quant_tables
    from fhetpu_torch.core import dct_kernel, ntt_kernel, server_kernel
    from fhetpu_torch.pipelines.jpeg_encode import server_compute_fn

    clock_hz = float(smi("clocks.max.sm").split()[0]) * 1e6
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"phase 5: bounds from {HBM_BYTES_PER_S / 1e12} TB/s HBM and {sms} SMs x "
          f"{clock_hz / 1e6:.0f} MHz x (64 FMA-pipe + 64 ALU-pipe int32 lanes, 128 issued)",
          flush=True)
    par = BfvParams.create(n=TIMING_N)
    ev = Evaluator(par, device=dev)
    st = ev.server_state(dev)
    m = server_kernel.lazy_bound_multiple(ev)
    x = rand_residues((TIMING_NB, 3, 64, 2), par.q_primes, par.n, gen, dev)
    gib = x.numel() * 4 / 2**30
    xf = ntt_kernel.ntt_forward(x, st.ntt)
    quant = build_quant_tables(0)[0][ZIGZAG].astype(np.float64)
    whole = {}
    for path, op, reps in (("strict", server_compute_fn(ev), 10),
                           ("quantize", server_compute_fn(ev, apply_quantize=True,
                                                          quant=quant), 3)):
        whole[path] = time_ms(lambda: op(x), reps)
        rate = TIMING_NB * 3 / (whole[path] / 1e3)
        print(f"phase 5: {path} server op n={par.n} nb={TIMING_NB} ({gib:.2f} GiB in): "
              f"{whole[path]:.3f} ms, {rate:.1f} channel-blocks/s [{card}]", flush=True)
        torch.cuda.empty_cache()
    pairs = {
        "ntt_forward": (lambda: ntt_kernel.ntt_forward(x, st.ntt),
                        lambda: ntt_kernel.ntt_plain(x, st.ntt)),
        "server_ycc_dct": (lambda: server_kernel.server_ycc_dct_fused(ev, xf),
                           lambda: server_kernel.server_ycc_dct_plain(xf, st)),
        "ntt_inverse": (lambda: ntt_kernel.ntt_inverse(xf, st.ntt),
                        lambda: ntt_kernel.intt_plain(xf, st.ntt)),
        "server_ycc_dct_lazy": (lambda: server_kernel.server_ycc_dct_fused(ev, xf, lazy=True),
                                lambda: server_kernel.server_ycc_dct_lazy_plain(xf, st, m)),
        "dct8x8": (lambda: dct_kernel.dct8x8_kernel(ev, xf),
                   lambda: dct_kernel.dct8x8_plain(xf, st)),
    }
    times = {}
    for name, (kern, plain) in pairs.items():
        e = max_abs_err(kern(), plain())
        errs[name] = max(errs[name], e)
        check(e == 0, f"{name} kernel vs plain at n={par.n} nb={TIMING_NB}: {e}")
        torch.cuda.empty_cache()
        k_ms = time_ms(kern, 10)
        p_ms = time_ms(plain, 2)
        nbytes, ops = kernel_work(name, x, par.L, par.n, m)
        t_bytes, t_ops = bound_times(nbytes, ops, sms, clock_hz)
        b_ms, b_by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
        times[name] = (k_ms, p_ms, b_ms, b_by)
        print(f"phase 5: {name} n={par.n} nb={TIMING_NB}: kernel {k_ms:.3f} ms "
              f"({TIMING_NB * 3 / (k_ms / 1e3):.1f} channel-blocks/s), plain torch "
              f"{p_ms:.3f} ms, bit-equal; bound {b_ms:.3f} ms by {b_by} (HBM "
              f"{t_bytes:.3f} ms, integer {t_ops:.3f} ms; "
              f"{nbytes / 1e9:.3f} GB, {ops.sum() / 1e9:.2f} G int32 ops of which "
              f"{ops[0] / 1e9:.2f} G FMA-pipe, {ops[1] / 1e9:.2f} G ALU-pipe; "
              f"{100 * b_ms / k_ms:.1f} % of it reached) [{card}]", flush=True)
        torch.cuda.empty_cache()
    return whole, times


NOISE_ARTIFACT = os.path.join("bench_results", "noise_validation.json")


def _bench_module(args: list, cwd: str, timeout: int) -> subprocess.CompletedProcess:
    """``python -m fhetpu_torch.bench.<args>`` as its user runs it, with the
    checkout importable; its output is returned, a non-zero exit raises."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p))
    r = subprocess.run([sys.executable, "-m"] + args, cwd=cwd, env=env, capture_output=True,
                       text=True, timeout=timeout)
    check(r.returncode == 0, f"{' '.join(args)} exited {r.returncode}:\n{r.stdout[-3000:]}"
                             f"\n{r.stderr[-3000:]}")
    return r


def phase_bench():
    """Phase 6: the measurement layer (fhetpu_torch.bench) on the card, each
    entry point as its user calls it: the headline at the four ring
    degrees, the noise sweep against fhetpu's committed artifact, and the
    --quick configurations of both sweeps."""
    import contextlib
    import io

    from fhetpu_torch.bench import analyze, headline
    from fhetpu_torch.bench import noise_validation as nv

    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as d:
        # 6a: the headline, its JSON line printed as the module prints it
        details = os.path.join(d, "bench_details_torch.json")
        out = io.StringIO()
        reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = headline.main(["--device", "cuda", "--details", details])
        launches = read_launches()
        lines = out.getvalue().strip().splitlines()
        check(rc == 0 and len(lines) == 1, f"headline printed {lines}")
        print(lines[0], flush=True)
        with open(details) as f:
            table = json.load(f)
        for n in DEGREES:
            row = table["per_n"][str(n)]
            for label, _, _ in headline.VARIANTS:
                v = row["variants"][label]
                refused = label == "lazy_nttfree" and n == 16384
                check(("error" in v) == refused, f"headline n={n} {label}: {v}")
            print(f"phase 6a: headline n={n} nb={row['nb']} ({row['bytes_in'] / 1e9:.2f} GB in): "
                  + "; ".join(
                      f"{label} " + ("refused" if "error" in v else
                                     f"min {v['ms_per_op_min']:.4f} ms of "
                                     + ", ".join(f"{s:.4f}" for s in v['ms_per_op_samples'])
                                     + f" ({v['channel_blocks_per_s']:.1f} channel-blocks/s, "
                                       f"{v['vs_baseline']:.2f}x SEAL)")
                      for label, v in row["variants"].items())
                  + f"; headline {row['headline_variant']} {row['channel_blocks_per_s']:.1f} "
                    f"channel-blocks/s, {row['vs_baseline']:.2f}x SEAL", flush=True)
        check(all(launches[k] > 0 for k in ("ntt_forward", "ntt_inverse", "server_ycc_dct",
                                            "server_ycc_dct_lazy")),
              f"headline: a kernel of its variants never launched: {launches}")
        print(f"phase 6a: headline in {time.perf_counter() - t0:.1f} s (host clock); "
              f"launches {launches}", flush=True)

        # 6b: every point of fhetpu's noise sweep, measured on the card
        out = io.StringIO()
        reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = nv.main(["--from-artifact", os.path.join(root, NOISE_ARTIFACT),
                          "--device", "cuda"])
        launches = read_launches()
        wall = time.perf_counter() - t0
        rows = [json.loads(ln) for ln in out.getvalue().splitlines() if ln.startswith("{")]
        with open(os.path.join(root, NOISE_ARTIFACT)) as f:
            n_points = len(json.load(f))
        differ = [r for r in rows if not r["equal"]]
        check(rc == 0 and len(rows) == n_points and not differ,
              f"noise sweep: {len(rows)} of {n_points} points, differing: {differ}")
        check(all(launches[k] > 0 for k in ("ntt_forward", "ntt_inverse", "server_ycc_dct")),
              f"noise sweep: a kernel of its paths never launched: {launches}")
        by_pipe = {}
        for r in rows:
            by_pipe[r["pipeline"]] = by_pipe.get(r["pipeline"], 0.0) + r["seconds"]
        slowest = max(rows, key=lambda r: r["seconds"])
        print(f"phase 6b: noise sweep, all {len(rows)} points of {NOISE_ARTIFACT} measured "
              f"on the card: every budget equal to the artifact's (fhetpu on a TPU); "
              f"{wall:.1f} s (host clock), by pipeline "
              + ", ".join(f"{p} {s:.1f} s" for p, s in by_pipe.items())
              + f"; slowest {slowest['pipeline']} n={slowest['n']} t={slowest['t']} "
                f"{slowest['seconds']:.1f} s; launches {launches}", flush=True)

        # 6c, 6d: the sweeps' --quick configurations, servers on the card as
        # subprocesses (their launches are counted in those processes)
        logs, work = os.path.join(d, "benchlogs"), os.path.join(d, "benchwork")
        t0 = time.perf_counter()
        _bench_module(["fhetpu_torch.bench.benchmark", "--quick", "--out", logs,
                       "--workdir", work], d, 900)
        with open(os.path.join(logs, "grid_results.json")) as f:
            grid = {r["pipeline"]: r for r in json.load(f)}
        op = {"jpg": "DCT", "bilinear": "Linear", "bicubic": "Cubic"}
        for kind, label in op.items():
            r = grid.get(kind)
            check(r is not None and {label, "Encryption", "Decryption", "RMSError"}
                  <= set(r["ops"]), f"benchmark --quick {kind}: rows {r}")
        print(f"phase 6c: benchmark --quick (n=4096, t=2^14, 16x16 -> 8x8) in "
              f"{time.perf_counter() - t0:.1f} s: "
              + "; ".join(f"{kind} {label} {grid[kind]['ops'][label]['mean_ms']} ms/unit, "
                          f"Encryption {grid[kind]['ops']['Encryption']['mean_ms']}, "
                          f"Decryption {grid[kind]['ops']['Decryption']['mean_ms']}, "
                          f"RMSError {grid[kind]['rms']}" for kind, label in op.items()),
              flush=True)
        dout = os.path.join(d, "decode_out")
        t0 = time.perf_counter()
        _bench_module(["fhetpu_torch.bench.decode_sweep", "--quick", "--out", dout,
                       "--workdir", os.path.join(d, "decodework")], d, 900)
        stats = analyze.parse_log(os.path.join(dout, "sweep.log"))
        check({"Encryption", "Step", "Decryption", "RMSError"} <= set(stats),
              f"decode_sweep --quick: rows {sorted(stats)}")
        check(any(f.startswith("out_12_0.5.") for f in os.listdir(dout)),
              f"decode_sweep --quick wrote {os.listdir(dout)}")
        print(f"phase 6d: decode_sweep --quick (trusted, 48x48, n=4096, degree 12, delta 0.5) "
              f"in {time.perf_counter() - t0:.1f} s: Step {np.mean(stats['Step']):.6g} "
              f"ms/unit, RMSError {stats['RMSError'][0]}", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from fhetpu_torch.core import build

    dev = torch.device("cuda:0")
    if os.path.exists(build.LIB_PATH):
        os.remove(build.LIB_PATH)  # build from the checkout's sources
    t0 = time.perf_counter()
    build.lib()
    card = smi("name,power.limit")
    print(f"phase 1: built {os.path.relpath(build.LIB_PATH)} in "
          f"{time.perf_counter() - t0:.1f} s; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    for usage in resource_usage(build.LIB_PATH):
        print(f"phase 1: {usage}", flush=True)
    for line in ntt_occupancy():
        print(f"phase 1: {line}", flush=True)
    print(f"phase 1: {server_occupancy()}", flush=True)
    print(card, flush=True)

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    errs = {name: 0 for name in KERNELS}
    phase_ntt(dev, gen, errs)
    phase_server(dev, gen, errs)
    launches = phase_main_paths(dev)
    phase_resize_paths(dev)
    phase_decode_paths(dev)
    _, times = phase_timing(dev, gen, errs, card)
    phase_resize_timing(dev, gen, card)
    phase_decode_timing(dev, card)
    phase_bench()

    report = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": errs[name],
         "ms": times[name][0], "plain_ms": times[name][1],
         "bound_ms": times[name][2], "bound_by": times[name][3],
         "library_ms": None}  # no single PyTorch call computes any of these
        for name, (src, rep) in KERNELS.items()
    ]}
    print(json.dumps(report))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
