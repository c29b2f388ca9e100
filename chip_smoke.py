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
  5. CUDA-event times of the whole server op, strict and --quantize, and of
     each kernel against its plain version at n=4096 and the CLI's 64-block
     chunk, beside each kernel's bound on this card.

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
    _, times = phase_timing(dev, gen, errs, card)

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
