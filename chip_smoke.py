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
  3b. the BEHZ floor-convert kernel (steps 3-4 of rns.multiply on the card)
     against the torch steps it replaces (t x_q, t x_bsk, scale_floor_to_bsk,
     convert_bsk_to_q), bit-equal, at the bilinear resize's shapes (n = 4096,
     L = 4, M = 2601 and 3468 components) and at L = 2, 8, 15 and 16 (the
     native n = 16384 chain), on random residues with one component at
     p - 1; one launch and M * n positions counted a call; CUDA-event times
     of both at each shape and per bilinear image (its six launches) beside
     the kernel's bound (72 B a position at L = 4, or its fewest int32
     operations); then the same for the extension kernel (step 1) against
     extend_q_to_bsk, at the resize's M = 1734, 2601 and 34 and the other
     L, per bilinear image its twelve launches beside 40 B a position;
  3d. the BEHZ tensor kernel (step 2 on the card) against the torch loop it
     replaces (rns.tensor_product, int64 on the card), bit-equal, at every
     product of a bilinear image (n = 4096, L = 4: 2x2, 2x3, 3x2 with their
     broadcast fract operands) and of a bicubic image (n = 8192, L = 8: 2x4,
     2x3, 2x2 and 5x4, 5x3, 5x2 at tiles of 4 and 1 rows), on random
     residues with one batch entry of each operand at p - 1, and at L = 2,
     15 and 16, a square and 9 x 2 (past its register path); one launch and
     the broadcast batch x (k1 + k2 - 1) x n positions counted a call;
     CUDA-event times of both at each product and per bilinear (6 products)
     and bicubic (75) image, beside the kernel's bound: 4 (L + K) bytes a
     position, the operands' positions read once and the product's written
     once;
  3c. the harmonic expansion kernel (the decode server's step on the card)
     against its plain torch version (rle_decode.expand_harmonics_plain),
     bit-equal, at the decode cell's shape (H = 25 harmonics, P = 2304
     positions, size 2, n = 2048, L = 2) on random residues, and with every
     table word and harmonic residue at q - 1 (P = 64); one launch and
     H * P * L * n table words counted a call; CUDA-event times of both
     beside the kernel's bound (its bytes once over HBM's rate);
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
        on each the NTT kernels launch and the JPEG kernels do not, the BEHZ
        floor-convert kernel launches with encrypted fracts and not with
        plain ones, the decoded values are within 1e-5 of resize_float, and the RMS against
        the cv ground truth and the peak device memory are printed; every
        path of a stream decrypts to the --plain-fracts path's polynomials
        exactly, and every output row to the golden network's;
     i-k. the decode main paths on the same image: i. harmonics (48x48,
        the chooser's n = 2048, order 64, degree 12) through
        client_decode -> server_decode --device cuda -> client_decode,
        both NTT kernels launched and no JPEG kernel, pixels within 1 of
        trunc+clamp of the exact series, channel 0's first 64 positions
        equal to expand_harmonics_server on the card and on the CPU, the
        expansion kernel launched once a channel;
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
        variant runs but the lazy one at n = 16384, which is refused; the
        native28 rows (the lazy op on the native chain, m = 2) at n = 8192
        and 16384, and at no other n;
     b. fhetpu_torch.bench.noise_validation --from-artifact on all 66
        points of bench_results/noise_validation.json: every measured
        budget equal to the artifact's (tolerance 0), seconds per pipeline;
     c. fhetpu_torch.bench.benchmark --quick (jpg, bilinear, bicubic at
        n = 4096, t = 2^14, servers as subprocesses on the card): rc 0 and
        each config's op, Encryption, Decryption and RMSError rows parsed;
     d. fhetpu_torch.bench.decode_sweep --quick: rc 0, its rows parsed;
  7. fhetpu_torch.parallel, every launch count set to 0 before each path
     and read after, every comparison exact:
     a. the JPEG op data-parallel over 8 logical shards on the card (the
        image's 36 blocks padded to 40) bit-equal to the unsharded op, one
        launch per shard of each kernel; server_jpeg --sharded over every
        card, default and --quantize, writes the unsharded stream byte for
        byte, through the NTT kernels and the fused or the DCT-only kernel;
     b. the halo resize, 48x48 -> 17x17, over 4 logical shards: bilinear
        with encrypted fracts (n = 4096) decrypts to the tile path's
        polynomials, as server_resize --sharded does with encrypted and
        plain fracts (the plain stream byte-equal to the tile path's);
        bicubic with plain fracts (n = 8192) and the gather shape (32 -> 4
        rows over 8 shards, n = 2048) residue-equal to the tile path on
        random residues; the NTT kernels launch, no JPEG kernel;
     c. init_distributed at world size 1 with NCCL: the rank's blocks, the
        op and an all_reduce'd checksum;
     d. CUDA-event times of the dp op at D = 1, 4, 8 and of the bilinear
        resize at D = 1, 4 on the one card against the unsharded paths:
        the machinery's own cost (padding, copies), not a speedup;
     e. on a host with more than one card, (a) and (b) over distinct cards;
  8. the last slice's modules, every launch count set to 0 before each path
     and read after, every comparison exact:
     a. the 48x48 image encrypted on the native chain of <= 28-bit primes
        at n = 8192 (BfvParams.create_native: lazy m = 2 where the SEAL
        chain gives 1) through server_compute_fn(fused_lazy=True), NTT
        kernels in and out: the NTTs and the lazy kernel launch, the strict
        kernel does not, and the output decrypts to the golden oracle;
     b. the native chain at n = 16384 (L = 16), 1.61 GB of random residues:
        the lazy kernel at m = 2 against its plain version and the strict
        kernel, the NTT kernels on the native q against theirs, and the lazy
        kernel's CUDA-event time beside its bound;
     c. python -m fhetpu_torch.bench.core --only
        ntt_sweep,ntt_fwd,ntt_inv,behz,relinearize,linear,harmonics_order16
        under its own timeout: rc 0 and every section present, its numbers
        printed.
  9. the last slice's functions and the NTT kernels at small batches:
     a. make_server on phase 5's input (n = 4096, nb = 64, coefficient
        form), default and --quantize, each driven with every launch count
        set to 0 just before it and read just after: bit-equal to
        server_compute_fn, through the NTT kernels and the fused kernel
        (the DCT-only kernel with --quantize);
     b. at n = 2048 and 16384 on q: ntt_forward -> pointwise mulmod ->
        ntt_inverse on the card for a sparse a (16 non-zero coefficients
        per prime, the wrap-around terms among them) and a dense b equals
        negacyclic_convolve_naive prime by prime; the kernels bit-equal to
        their plain versions on these inputs;
     c. each NTT kernel's device time per launch at n = 4096, L = 4 and
        B = 16, 64, 256 polynomials x L, with the L2 cache flushed before
        each launch and warm, in a spawned process, from torch.profiler
        (the mean of 20 launches, each of which it must see) and from CUDA
        events around each launch enqueued behind a sleep kernel, beside
        its bound (the data's 2*4*B*L*n bytes plus the twiddle tables over
        3.35 TB/s, or the integer operations, whichever is larger).
 10. the CLIs reading a pipe, as fhetpu's do, on phase 4's stream files:
     a. python -m fhetpu_torch.cli.server_jpeg --device cuda -i <FIFO fed by
        a thread> byte-equal to 4a's output from the file, its
        --profile-dir trace showing both NTT kernels and the fused kernel;
     b. python -m fhetpu_torch.cli.server_decode --device cuda -i /dev/stdin
        with 4i's harmonic stream piped in: decrypts to 4i's pixels, the
        NTT kernels in its trace and no JPEG kernel;
     c. client_jpeg --recieve from a FIFO: the file run's RMSError line and
        JFIF bytes.

Every torch.profiler reading (phases 5 and 9c, each in a fresh process,
and 10) fails the run if the profiler saw no device time or missed
a launch that the wrappers counted in its window.

The last lines are a JSON object of the kernels (the BEHZ kernel's row: its
launches on path 4d, its times and bound per bilinear image, phase 3b), the
card's name and power
limit from nvidia-smi, and {"ok": true, "device": {...}}.  Imports neither
JAX, nor PIL, nor anything of the fhetpu package.  Exits non-zero without a
CUDA device.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

# The benchmark's roofline model (perfbench/roofline.py): bytes over HBM's
# rate, and the fewest int32 operations of an op graph that gives each
# kernel's output bits (the lazy graph where the primes leave headroom) as
# (FMA-pipe, ALU-pipe, either) operations over the SMs' pipes.  NVIDIA's CUDA
# C++ Programming Guide gives compute capability 9.0 64 results per SM per
# clock for 32-bit integer add, multiply(-add), compare and min/max; Nsight
# Compute's pipe table puts IMAD/IMUL on the FMA pipe and compares, min/max
# and logic on the ALU pipe, and an add runs on either (IADD3 or IMAD.IADD).
try:
    from perfbench.roofline import (DISPATCH_PER_CLOCK, HBM_BYTES_PER_S, LANE_OPS_PER_CLOCK,
                                    LAZY_ADD, LAZY_DCT, LAZY_MUL, RED, bound_s, ntt_ops,
                                    ycc_dct_ops)
except ModuleNotFoundError as e:
    # perfbench/ is beside this script in a checkout; a copy of the script
    # alone must still reach main(), which refuses to run without the repo
    if e.name != "perfbench":
        raise

SEED = 20261016
IMG_HW = 48  # the reference benchmark's image size (BASELINE.md)
DEGREES = (2048, 4096, 8192, 16384)
TIMING_N = 4096
TIMING_NB = 64  # the CLI's default --chunk-blocks
NTT_BATCH = 301  # more polynomials than one wave of the NTT's persistent grid
RAGGED = (1, 3, 7)

KERNELS = {
    "server_ycc_dct": ("fhetpu_torch/csrc/server_ycc_dct_strict.cu",
                       "fhetpu/core/pallas_server.py:237"),
    "ntt_forward": ("fhetpu_torch/csrc/ntt.cu", "fhetpu/core/pallas_ntt.py:98"),
    "ntt_inverse": ("fhetpu_torch/csrc/ntt.cu", "fhetpu/core/pallas_ntt.py:98"),
    "server_ycc_dct_lazy": ("fhetpu_torch/csrc/server_ycc_dct.cu",
                            "fhetpu/core/pallas_server.py:191"),
    "dct8x8": ("fhetpu_torch/csrc/dct.cu", "fhetpu/core/pallas_dct.py:161"),
    # BEHZ steps 3-4, 1 and 2, which fhetpu computes as XLA ops, not TPU kernels
    "behz_floor_convert": ("fhetpu_torch/csrc/behz_floor_convert.cu",
                           "fhetpu/bfv/rns.py:197"),
    "behz_extend": ("fhetpu_torch/csrc/behz_extend.cu", "fhetpu/bfv/rns.py:146"),
    "behz_tensor": ("fhetpu_torch/csrc/behz_tensor.cu", "fhetpu/bfv/rns.py:279"),
    # the decode server's expansion, which fhetpu leaves to XLA as a jitted fori_loop
    "harmonic_expand": ("fhetpu_torch/csrc/harmonic_expand.cu",
                        "fhetpu/pipelines/rle_decode.py:384"),
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
                              r"|dct8x8_kernel|ntt_kernelILb\dELi\d+"
                              r"|behz_floor_convert_kernelILi\d+ELi\d"
                              r"|behz_extend_kernelILi\d+ELi\d"
                              r"|behz_tensor_kernelILi\d+ELi\dELi\d"
                              r"|harmonic_expand_kernelILi\d)", found.group(1))
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
    from fhetpu_torch.core import behz_kernel, dct_kernel, expand_kernel, ntt_kernel, server_kernel

    return {"server_ycc_dct": (server_kernel.server_ycc_dct_fused, "launches"),
            "ntt_forward": (ntt_kernel.ntt_forward, "launches"),
            "ntt_inverse": (ntt_kernel.ntt_inverse, "launches"),
            "server_ycc_dct_lazy": (server_kernel.server_ycc_dct_fused, "lazy_launches"),
            "dct8x8": (dct_kernel.dct8x8_kernel, "launches"),
            "behz_floor_convert": (behz_kernel.behz_floor_convert, "launches"),
            "behz_extend": (behz_kernel.behz_extend, "launches"),
            "behz_tensor": (behz_kernel.behz_tensor, "launches"),
            "harmonic_expand": (expand_kernel.harmonic_expand, "launches")}


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


# The BEHZ floor-convert kernel's shapes, (n, native chain, components M,
# launches per bilinear 48x48 -> 17x17 image): the resize's two products at
# n = 4096 (867 ciphertexts x 3 and x 4 output components), then each other
# L the kernel is built for (2, 8, 15 and, on the native chain, 16)
BEHZ_SHAPES = ((4096, False, 2601, 4), (4096, False, 3468, 2), (2048, False, 4096, 0),
               (8192, False, 1024, 0), (16384, False, 128, 0), (16384, True, 128, 0))


def behz_work(L: int, positions: int) -> tuple:
    """(bytes, [FMA, ALU, either] int32 operations) of the floor-convert
    kernel over ``positions`` (component, coefficient) pairs: 4(L + K)
    bytes read and 8L written a position (72 B at L = 4), and the
    operations of csrc/behz_floor_convert.cu's graph."""
    ADD = LAZY_ADD + RED  # a + b and a + b - p, then their min
    MUL = LAZY_MUL + RED  # Shoup, then a subtraction of p and a min
    K, nb = L + 2, L + 1
    term = LAZY_MUL + ADD  # a lazy product added to a lazy sum
    sub = LAZY_ADD + 2 * RED  # a + 2p - b, made canonical
    per = (L * MUL + K * (L * term + LAZY_MUL + sub) + nb * term + sub
           + L * (LAZY_MUL + nb * term + RED))
    return positions * (4 * (L + K) + 8 * L), positions * per


# The BEHZ extension kernel's shapes, as BEHZ_SHAPES: the resize's operands
# at n = 4096 (867 ciphertexts x 2 and x 3 components, and the 17 x 2 fract
# components they meet), then each other L the kernel is built for
EXTEND_SHAPES = ((4096, False, 1734, 4), (4096, False, 2601, 2), (4096, False, 34, 6),
                 (2048, False, 4096, 0), (8192, False, 1024, 0), (16384, False, 128, 0),
                 (16384, True, 128, 0))


def extend_work(L: int, positions: int) -> tuple:
    """(bytes, [FMA, ALU, either] int32 operations) of the extension kernel
    over ``positions`` (component, coefficient) pairs: 4L bytes read and 4K
    written a position (40 B at L = 4), and the operations of
    csrc/behz_extend.cu's graph: L reduced Shoup products (z), L multiply-adds
    and a mask, compare, subtract and select (r), then per Bsk prime L lazy
    products added to r's and one reduction."""
    K = L + 2
    term = LAZY_MUL + LAZY_ADD + RED  # a lazy product added to a lazy sum
    per = (L * (LAZY_MUL + RED) + L * np.array([1, 0, 0]) + np.array([0, 2, 2])
           + K * (LAZY_MUL + L * term + RED))
    return positions * 4 * (L + K), positions * per


def phase_behz(dev, gen, errs, card) -> dict:
    """Phase 3b: the BEHZ floor-convert kernel against the torch steps it
    replaces on the card (t x_q, t x_bsk, scale_floor_to_bsk,
    convert_bsk_to_q) at BEHZ_SHAPES, and the extension kernel against
    extend_q_to_bsk at EXTEND_SHAPES, on random residues with the last
    component at p - 1 in every base: bit-equal, one launch and M * n
    positions a call; CUDA-event times of both beside the kernel's bound.
    Returns each kernel's (kernel ms, torch steps ms, bound ms, what bounds
    it) per bilinear image."""
    import torch
    from fhetpu_torch.core import behz_kernel, modops

    def operands(par, m, n, bases):
        return [torch.cat([rand_residues((m - 1,), primes, n, gen, dev),
                           worst_residues((1,), primes, n, dev)])
                for primes in (par.q_primes, par.bsk_primes)[:bases]]

    def floor_convert_steps(tool, xq, xb):
        tx_q = modops.mulmod(modops.to_i64(xq), tool.t_mod_q, tool.qp)
        tx_b = modops.mulmod(modops.to_i64(xb), tool.t_mod_bsk, tool.bp)
        return tool.convert_bsk_to_q(tool.scale_floor_to_bsk(tx_q, tx_b))

    clock_hz = float(smi("clocks.max.sm").split()[0]) * 1e6
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    fc, ex = behz_kernel.behz_floor_convert, behz_kernel.behz_extend
    # kernel -> (label, oracle, shapes, operand bases, work, out dtype, launches
    # an image, the wrapper's call, the torch steps)
    kernels = {
        "behz_floor_convert": ("floor-convert", "the torch steps", BEHZ_SHAPES, 2, behz_work,
                               torch.int64, 6, lambda tool, *xs: fc(*xs, tool.floor_convert_table),
                               floor_convert_steps),
        "behz_extend": ("extension", "extend_q_to_bsk", EXTEND_SHAPES, 1, extend_work,
                        torch.uint32, 12, lambda tool, x: ex(x, tool.extend_table),
                        lambda tool, x: tool.extend_q_to_bsk(modops.to_i64(x))),
    }
    return {name: _behz_kernel_times(dev, name, spec, operands, errs, card, clock_hz, sms)
            for name, spec in kernels.items()}


def _behz_kernel_times(dev, name, spec, operands, errs, card, clock_hz, sms) -> tuple:
    """One kernel of phase 3b (``spec`` as in phase_behz) at each of its
    shapes; (kernel ms, torch steps ms, bound ms, what bounds it) per
    bilinear image."""
    import torch
    from fhetpu_torch.bfv import rns
    from fhetpu_torch.bfv.params import BfvParams
    from fhetpu_torch.core import behz_kernel

    label, oracle, shapes, bases, work, dtype, launches, kernel, steps = spec
    wrapper = getattr(behz_kernel, name)
    image_ms, image_bytes, image_ops = np.zeros(2), 0, 0
    for n, native, m, per_image in shapes:
        par = (BfvParams.create_native if native else BfvParams.create)(n=n)
        tool = rns.RnsTool(par, dev)
        L = par.L
        xs = operands(par, m, n, bases)
        before = (wrapper.launches, wrapper.positions)
        got = kernel(tool, *xs)
        torch.cuda.synchronize()
        counted = (wrapper.launches - before[0], wrapper.positions - before[1])
        check(counted == (1, m * n), f"BEHZ {label} n={n} L={L} M={m}: counted {counted}")
        want = steps(tool, *xs)
        e = max_abs_err(got, want)
        errs[name] = max(errs[name], e)
        check(got.dtype == dtype and got.shape == want.shape and e == 0,
              f"BEHZ {label} kernel vs {oracle} at n={n} L={L} M={m}: max abs err {e}")
        del got, want
        torch.cuda.empty_cache()
        k_ms, s_ms = time_ms(lambda: kernel(tool, *xs), 20), time_ms(lambda: steps(tool, *xs), 3)
        nbytes, ops = work(L, m * n)
        t_bytes, t_ops = bound_times(nbytes, ops, sms, clock_hz)
        b_ms, b_by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
        print(f"phase 3b: BEHZ {label} n={n} L={L}{' native' if native else ''} M={m}, "
              f"random + 1 at p-1: kernel bit-equal to {oracle}, 1 launch, {m * n} "
              f"positions; kernel {k_ms:.4f} ms, torch steps {s_ms:.3f} ms; bound {b_ms:.4f} ms "
              f"by {b_by} (HBM {t_bytes:.4f} ms, integer {t_ops:.4f} ms; {nbytes / 1e9:.3f} GB, "
              f"{ops.sum() / 1e9:.2f} G int32 ops); {100 * b_ms / k_ms:.1f} % of it reached "
              f"[{card}]", flush=True)
        image_ms += per_image * np.array([k_ms, s_ms])
        image_bytes, image_ops = image_bytes + per_image * nbytes, image_ops + per_image * ops
        del xs, tool
        torch.cuda.empty_cache()
    t_bytes, t_ops = bound_times(image_bytes, image_ops, sms, clock_hz)
    b_ms, b_by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    print(f"phase 3b: BEHZ {label} per bilinear 48x48 -> 17x17 image ({launches} launches): "
          f"kernel {image_ms[0]:.4f} ms, torch steps {image_ms[1]:.3f} ms; bound {b_ms:.4f} ms "
          f"by {b_by} ({image_bytes / 1e9:.3f} GB, integer {t_ops:.4f} ms); "
          f"{100 * b_ms / image_ms[0]:.1f} % of it reached [{card}]", flush=True)
    return image_ms[0], image_ms[1], b_ms, b_by


# The BEHZ tensor kernel's products, (n, k1, k2, a's batch, b's batch,
# products an image): a bilinear 48x48 -> 17x17 image at n = 4096 (one tile:
# the grid by the column fracts 1 - t and t, twice each, then the columns'
# 3-component results by the row fracts), then a bicubic image at n = 8192
# (tiles of 4, 4, 4, 4 and 1 rows; in each, four Catmull-Rom steps along the
# columns multiply size-2 a, b, c by t^3, t^2, t, and one along the rows
# size-5 a, b, c by the rows' t^3, t^2, t)
BILINEAR_PRODUCTS = ((4096, 2, 2, (1, 17, 1), (17, 17, 3), 2),
                     (4096, 2, 2, (17, 17, 3), (1, 17, 1), 2),
                     (4096, 2, 3, (17, 1, 1), (17, 17, 3), 1),
                     (4096, 3, 2, (17, 17, 3), (17, 1, 1), 1))
BICUBIC_PRODUCTS = tuple(
    (8192, k1, k2, (rows, 17, 3), fract, count)
    for rows, tiles in ((4, 4), (1, 1))
    for k1, k2, fract, count in ((2, 4, (1, 17, 1), 4 * tiles), (2, 3, (1, 17, 1), 4 * tiles),
                                 (2, 2, (1, 17, 1), 4 * tiles), (5, 4, (rows, 1, 1), tiles),
                                 (5, 3, (rows, 1, 1), tiles), (5, 2, (rows, 1, 1), tiles)))
# checked only: the other L (native n = 16384 for L = 16), a square (b None)
# and sizes past the register path
TENSOR_CHECKS = ((2048, False, 2, 2, (3, 5), (5,)), (16384, False, 3, 2, (2,), (1,)),
                 (16384, True, 2, 2, (2, 1), (3,)), (4096, False, 3, 3, (5,), None),
                 (4096, False, 9, 2, (3,), (1,)))


def phase_tensor(dev, gen, errs, card) -> tuple:
    """Phase 3d: the BEHZ tensor kernel against the torch loop it replaces on
    the card (rns.tensor_product) at BILINEAR_PRODUCTS, BICUBIC_PRODUCTS and
    TENSOR_CHECKS, on random residues with the first batch entry of each
    operand at p - 1: bit-equal, one launch and the broadcast batch x
    (k1 + k2 - 1) x n positions a call; CUDA-event times of both at each
    product beside the kernel's byte bound, then per image.  Returns (kernel
    ms, torch loop ms, bound ms, "bytes") per bilinear image."""
    import torch
    from fhetpu_torch.bfv import rns
    from fhetpu_torch.bfv.params import BfvParams
    from fhetpu_torch.core import behz_kernel, modops

    fn = behz_kernel.behz_tensor
    tools = {}

    def operand(par, batch, k):
        out = []
        for primes in (par.q_primes, par.bsk_primes):
            x = rand_residues(tuple(batch) + (k,), primes, par.n, gen, dev)
            x.view((-1,) + x.shape[-3:])[0] = worst_residues((k,), primes, par.n, dev)
            out.append(x)
        return out

    def run(n, native, k1, k2, a_batch, b_batch, timed):
        par = (BfvParams.create_native if native else BfvParams.create)(n=n)
        if (n, native) not in tools:
            tools[n, native] = rns.RnsTool(par, dev)
        tool = tools[n, native]
        a = operand(par, a_batch, k1)
        b = a if b_batch is None else operand(par, b_batch, k2)
        before = (fn.launches, fn.positions)
        got = fn(*a, *b, tool.tensor_table)
        torch.cuda.synchronize()
        bshape = torch.broadcast_shapes(a[0].shape[:-3], b[0].shape[:-3])
        kout = k1 + k2 - 1
        out_positions = int(np.prod(bshape)) * kout * n
        counted = (fn.launches - before[0], fn.positions - before[1])
        what = f"BEHZ tensor n={n} L={par.L} {k1}x{k2} {tuple(a_batch)} x {b_batch}"
        check(counted == (1, out_positions), f"{what}: counted {counted}")
        wide = [modops.to_i64(x) for x in a + b]
        want = rns.tensor_product(*wide, tool)
        e = max(max_abs_err(g, w) for g, w in zip(got, want))
        errs["behz_tensor"] = max(errs["behz_tensor"], e)
        check(all(g.dtype == torch.uint32 and g.shape == w.shape for g, w in zip(got, want))
              and e == 0, f"{what}: kernel vs the torch loop, max abs err {e}")
        del got, want
        line = f"phase 3d: {what}, random + 1 entry at p-1: kernel bit-equal to the torch loop"
        if not timed:
            print(line, flush=True)
            return None
        k_ms = time_ms(lambda: fn(*a, *b, tool.tensor_table), 20)
        s_ms = time_ms(lambda: rns.tensor_product(*wide, tool), 3)
        read = (int(np.prod(a_batch)) * k1 + (0 if b_batch is None else
                                              int(np.prod(b_batch)) * k2)) * n
        nbytes = 4 * (par.L + par.L + 2) * (read + out_positions)
        b_ms = 1e3 * nbytes / HBM_BYTES_PER_S
        print(f"{line}; kernel {k_ms:.4f} ms, torch loop {s_ms:.3f} ms; bound {b_ms:.4f} ms by "
              f"bytes ({nbytes / 1e9:.4f} GB); {100 * b_ms / k_ms:.1f} % of it reached [{card}]",
              flush=True)
        del a, b, wide
        torch.cuda.empty_cache()
        return np.array([k_ms, s_ms, b_ms])

    for n, native, k1, k2, a_batch, b_batch in TENSOR_CHECKS:
        run(n, native, k1, k2, a_batch, b_batch, False)
    per_image = {}
    for label, products in (("bilinear", BILINEAR_PRODUCTS), ("bicubic", BICUBIC_PRODUCTS)):
        total = np.zeros(3)
        for n, k1, k2, a_batch, b_batch, count in products:
            total += count * run(n, False, k1, k2, a_batch, b_batch, True)
        count = sum(p[-1] for p in products)
        print(f"phase 3d: BEHZ tensor per {label} 48x48 -> 17x17 image ({count} launches): "
              f"kernel {total[0]:.4f} ms, torch loop {total[1]:.3f} ms; bound {total[2]:.4f} ms "
              f"by bytes; {100 * total[2] / total[0]:.1f} % of it reached [{card}]", flush=True)
        per_image[label] = total
    tools.clear()
    torch.cuda.empty_cache()
    k_ms, s_ms, b_ms = per_image["bilinear"]
    return k_ms, s_ms, b_ms, "bytes"


def phase_expand(dev, gen, errs, card) -> tuple:
    """Phase 3c: the harmonic expansion kernel against its plain torch
    version (rle_decode.expand_harmonics_plain) on the card at the decode
    cell's shape, on random residues and with every input at q - 1 (P = 64):
    bit-equal, one launch and H * P * L * n table words a call; CUDA-event
    times of both beside the kernel's bound, its bytes once over HBM's rate.
    Returns (kernel ms, torch ms, bound ms, what bounds it) a channel."""
    import torch
    from fhetpu_torch.bfv.params import BfvParams
    from fhetpu_torch.core import expand_kernel
    from fhetpu_torch.pipelines import rle_decode as rd

    fn = expand_kernel.harmonic_expand
    par = BfvParams.create(n=2048)
    qs, L, n = par.q_primes, par.L, par.n
    p = torch.tensor(qs, dtype=torch.int64, device=dev).reshape(-1, 1)
    H, P, S = 2 * DECODE["degree"] + 1, IMG_HW * IMG_HW, 2
    for what, tabs, harm in (
            ("random", rand_residues((H, P), qs, n, gen, dev),
             rand_residues((H, S), qs, n, gen, dev)),
            ("every input at q-1", worst_residues((H, 64), qs, n, dev),
             worst_residues((H, S), qs, n, dev))):
        before = (fn.launches, fn.words)
        got = fn(tabs, harm, qs)
        torch.cuda.synchronize()
        counted = (fn.launches - before[0], fn.words - before[1])
        check(counted == (1, tabs.numel()), f"expansion kernel, {what}: counted {counted}")
        want = rd.expand_harmonics_plain(tabs, harm.to(torch.int64), p)
        e = max_abs_err(got, want)
        errs["harmonic_expand"] = max(errs["harmonic_expand"], e)
        check(got.dtype == torch.uint32 and got.shape == want.shape and e == 0,
              f"expansion kernel vs the torch loop, {what}: max abs err {e}")
        del got, want
    torch.cuda.empty_cache()
    tabs = rand_residues((H, P), qs, n, gen, dev)
    harm = rand_residues((H, S), qs, n, gen, dev)
    harm64 = harm.to(torch.int64)
    k_ms = time_ms(lambda: fn(tabs, harm, qs), 20)
    t_ms = time_ms(lambda: rd.expand_harmonics_plain(tabs, harm64, p), 3)
    nbytes = (tabs.numel() + harm.numel() + P * S * L * n) * 4
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"phase 3c: harmonic expansion H={H} P={P} size {S} n={n} L={L}: kernel bit-equal to "
          f"the torch loop on random residues and with every input at q-1 (P=64), 1 launch and "
          f"H*P*L*n table words a call; kernel {k_ms:.4f} ms, torch loop {t_ms:.3f} ms; bound "
          f"{b_ms:.4f} ms by bytes ({nbytes / 1e9:.4f} GB; {H * P * S * L * n / 1e9:.3f} G "
          f"products); {100 * b_ms / k_ms:.1f} % of it reached [{card}]", flush=True)
    del tabs, harm, harm64
    torch.cuda.empty_cache()
    return k_ms, t_ms, b_ms, "bytes"


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
    """[nb, 3, 64, n] plaintext coefficients of YCC -> DCT (-> quantize),
    the blocks split over one spawned process per CPU core (at most 8): the
    golden network is single-threaded NumPy, minutes for 36 blocks at
    n = 8192 in one process."""
    import concurrent.futures
    import multiprocessing

    from fhetpu_torch.io import images

    blocks = np.stack(
        [images.split_blocks(img[..., c].astype(np.float64)) for c in range(3)], axis=1)
    parts = np.array_split(blocks, min(8, os.cpu_count() or 1, len(blocks)))
    with concurrent.futures.ProcessPoolExecutor(
            len(parts), mp_context=multiprocessing.get_context("spawn")) as pool:
        outs = list(pool.map(_golden_blocks, [encoder] * len(parts), parts,
                             [quant] * len(parts)))
    return np.concatenate(outs)


def _golden_blocks(encoder, blocks, quant):
    """_golden's network on pixel blocks [nb, 3, 64]."""
    from fhetpu_torch.bfv.golden import GoldenEvaluator
    from fhetpu_torch.pipelines import jpeg_encode as pipe

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


def phase_main_paths(dev, work):
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
        shutil.copytree(d, os.path.join(work, "jpeg"), copy_function=os.link)  # for phase 10
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
    to 0 just before it and read just after; the client decrypts.  Returns
    the BEHZ kernels' launches on the bilinear encrypted-fract path (4d)."""
    import torch
    from fhetpu_torch.bfv.encoder import FractionalEncoder
    from fhetpu_torch.cli import client_resize, server_resize
    from fhetpu_torch.io import images
    from fhetpu_torch.pipelines import resize as rz
    from fhetpu_torch.pipelines.cv_resize import cv_ground_truth

    img = np.random.default_rng(SEED).integers(0, 256, size=(IMG_HW, IMG_HW, 3),
                                               dtype=np.uint8)
    size = ["--width", str(RESIZE_HW), "--height", str(RESIZE_HW)]
    step, behz_launches = 0, None
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
                # ct x ct products, only with encrypted fracts: one tensor and one
                # floor-convert launch each, and one extension an operand (a
                # square's once)
                fc, ext, ten = (got[k] for k in ("behz_floor_convert", "behz_extend",
                                                 "behz_tensor"))
                check((fc > 0) == (path != "plain-fracts") and fc <= ext <= 2 * fc
                      and ten == fc and (mode == rz.BICUBIC or ext == 2 * fc),
                      f"{mode_name} {path}: BEHZ launches {got}")
                if behz_launches is None:
                    behz_launches = {"behz_floor_convert": fc, "behz_extend": ext,
                                     "behz_tensor": ten}
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
    return behz_launches


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


def phase_decode_paths(dev, work):
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
        of the series.
    Returns the expansion kernel's launches on 4i."""
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
        check(got["harmonic_expand"] == 3, f"decode harmonics: not one expansion a channel: {got}")
        expand_launches = got["harmonic_expand"]
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
        shutil.copytree(d, os.path.join(work, "decode"))  # for phase 10; 4j rewrites c2s.bin

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
    return expand_launches


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


def _self_device_us(evt) -> float:
    """A profiler event's own device time (the attribute's name depends on
    the torch version)."""
    us = getattr(evt, "self_device_time_total", None)
    return evt.self_cuda_time_total if us is None else us


def _device_times(prof) -> tuple:
    """(NTT kernels' ms, all kernels' ms) of a torch.profiler run: device
    time summed over the CUDA events (the NTT kernels by their name)."""
    import torch

    ntt_us = all_us = 0.0
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = _self_device_us(evt)
        all_us += us
        ntt_us += us if "ntt_kernel" in evt.key else 0.0
    return ntt_us / 1e3, all_us / 1e3


def _check_seen(prof, launched: dict, what: str) -> tuple:
    """Fails the run unless torch.profiler saw device time and, kernel
    family by family (TRACE_KERNELS), each launch that the wrappers counted
    in the profiled window; (device kernels in all, their device ms)."""
    import torch

    seen, kernels, us = dict.fromkeys(TRACE_KERNELS, 0), 0, 0.0
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        kernels += evt.count
        us += _self_device_us(evt)
        for family, pat in TRACE_KERNELS.items():
            seen[family] += evt.count if re.search(pat, evt.key) else 0
    check(kernels > 0 and us > 0, f"{what}: torch.profiler saw no device time")
    check(seen == launched, f"{what}: torch.profiler saw {seen}, the wrappers launched "
                            f"{launched}")
    return kernels, us / 1e3


@contextlib.contextmanager
def _profiled():
    """torch.profiler (CPU and CUDA) around the enclosed work, the card
    synchronized on both sides.  Used in fresh processes only
    (_in_fresh_process)."""
    import torch

    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        yield prof
        torch.cuda.synchronize()


def _ntt_share(fn, what: str) -> str:
    """The NTT kernels' share of one call's device time (torch.profiler);
    fails the run if the profiler missed a launch (_check_seen)."""
    reset_launches()
    with _profiled() as prof:
        fn()
    _check_seen(prof, read_launches(), what)
    ntt_ms, dev_ms = _device_times(prof)
    return (f"NTT kernels {ntt_ms:.3f} ms of {dev_ms:.3f} ms device time "
            f"({100 * ntt_ms / dev_ms:.1f} %)")


def _in_fresh_process(fn, *args):
    """fn(*args) in a newly spawned process.  torch.profiler there sees
    every launch; in a process that has profiled and worked before, it
    misses the first kernels of a window (PERF.md section 7)."""
    import concurrent.futures
    import multiprocessing

    with concurrent.futures.ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn")) as pool:
        return pool.submit(fn, *args).result()


def _resize_tile(dev, gen, mode_name: str, n: int) -> tuple:
    """Phase 5's resize tile (4 output rows x 17 columns, the server's
    default tile, over a source window of random residues) with encrypted
    fracts: (tile(), its parameters, its output rows, the host seconds of
    its fract operands)."""
    import torch
    from fhetpu_torch.bfv.crypto import Encryptor, KeyGenerator
    from fhetpu_torch.bfv.encoder import FractionalEncoder
    from fhetpu_torch.bfv.evaluator import Evaluator
    from fhetpu_torch.bfv.params import BfvParams
    from fhetpu_torch.cli.server_resize import tile_rows
    from fhetpu_torch.pipelines import resize as rz

    mode = rz.BICUBIC if mode_name == "bicubic" else rz.BILINEAR
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

    return tile, par, y1 - y0, host_s


def resize_tile_share(mode_name: str, n: int) -> str:
    """Phase 5's NTT share of one resize tile's device time; run by
    _in_fresh_process."""
    import torch

    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 5)
    tile = _resize_tile(dev, gen, mode_name, n)[0]
    tile()  # the first call builds the tables
    return _ntt_share(tile, f"phase 5 resize {mode_name} tile")


def phase_resize_timing(dev, gen, card):
    """CUDA-event ms of one resize tile (_resize_tile) for the bilinear
    (n=4096) and bicubic (n=8192) encrypted-fract ops, the host time of
    their fract operands, the NTT launches per tile on each base, the share
    of device time in the NTT kernels (torch.profiler, in a fresh process),
    interps/s and peak device memory."""
    import torch
    from fhetpu_torch.core import ntt_kernel

    for mode_name, n in RESIZE_TIMING:
        interp_per_px = 20 if mode_name == "bicubic" else 3  # the server's OpTimer units
        tile, par, rows, host_s = _resize_tile(dev, gen, mode_name, n)
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
        del tile
        torch.cuda.empty_cache()
        share = _in_fresh_process(resize_tile_share, mode_name, n)
        interps = rows * RESIZE_HW * interp_per_px
        print(f"phase 5: resize {mode_name} tile, n={n}, {rows} rows x {RESIZE_HW} columns x 3, "
              f"encrypted fracts, unrelinearized: {ms:.3f} ms per tile (CUDA events, 3 runs), "
              f"{interps / (ms / 1e3):.1f} interps/s; fract operands on the host {host_s:.3f} s; "
              f"NTT launches per tile {per_tile['ntt_forward']} forward, "
              f"{per_tile['ntt_inverse']} inverse, by base {sorted(bases.items())}; {share}, "
              f"torch int64 passes and copies the rest; peak device memory "
              f"{peak / 2**30:.3f} GiB [{card}]", flush=True)


def _decode_channel(dev) -> tuple:
    """Phase 5's harmonic expansion of one channel at 48x48 and the
    chooser's n=2048 (order 64, degree 12: 25 harmonics x 2304 positions),
    output back in coefficient form: (evaluator, harmonics, positions,
    channel())."""
    import torch
    from fhetpu_torch.bfv import crypto
    from fhetpu_torch.bfv.encoder import FractionalEncoder
    from fhetpu_torch.bfv.evaluator import Ct, Evaluator
    from fhetpu_torch.bfv.params import BfvParams
    from fhetpu_torch.pipelines import rle_decode as rd

    order, degree = DECODE["order"], DECODE["degree"]
    par = BfvParams.create(n=2048)
    encoder = FractionalEncoder(par.t, par.n)
    ev = Evaluator(par, encoder, device=dev)
    positions = np.arange(IMG_HW * IMG_HW)
    kg = crypto.KeyGenerator(par, seed=SEED)
    harm_vals = np.random.default_rng(SEED).uniform(-3000.0, 3000.0, size=2 * degree + 1)
    harm = Ct(torch.from_numpy(crypto.Encryptor(par, kg.public_key(), seed=SEED).encrypt_batch(
        encoder.encode_batch(harm_vals))).to(dev))

    def channel():
        return ev.transform_from_ntt(rd.expand_harmonics_batched(ev, harm, positions, order,
                                                                 degree))

    return ev, harm, positions, channel


def _pure_fhe_pair(dev) -> tuple:
    """Phase 5's pure-FHE step for one pair at n=16384 (t=2^24, 16
    positions, degree 2, relinearized): (parameters, pair())."""
    import torch
    from fhetpu_torch.bfv import crypto
    from fhetpu_torch.bfv.encoder import FractionalEncoder
    from fhetpu_torch.bfv.evaluator import Ct, DeviceRelinKeys, Evaluator
    from fhetpu_torch.bfv.params import BfvParams
    from fhetpu_torch.pipelines import rle_decode as rd

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

    return par, pair


def decode_channel_share() -> str:
    """Phase 5's NTT share of one decode channel's device time; run by
    _in_fresh_process."""
    import torch

    channel = _decode_channel(torch.device("cuda:0"))[-1]
    channel()  # the first call builds the weight tables
    return _ntt_share(channel, "phase 5 decode harmonic expansion")


def pure_fhe_pair_share() -> str:
    """Phase 5's NTT share of one pure-FHE pair's device time; run by
    _in_fresh_process."""
    import torch

    pair = _pure_fhe_pair(torch.device("cuda:0"))[1]
    pair()  # the first call builds the tables
    return _ntt_share(pair, "phase 5 decode pure-FHE pair")


def phase_decode_timing(dev, card):
    """The harmonic expansion of one channel (_decode_channel): the first
    call, which builds the weight tables (host encoding, upload, lift and
    one forward NTT; host clock), the tables' NTT alone and later calls from
    the cache (CUDA events), NTT launches per channel, the NTT share of
    device time (torch.profiler, in a fresh process), peak device memory
    and the bound from bytes; then CUDA-event ms per pure-FHE pair
    (_pure_fhe_pair) and its NTT share."""
    import torch
    from fhetpu_torch.core import ntt
    from fhetpu_torch.pipelines import rle_decode as rd

    order, degree = DECODE["order"], DECODE["degree"]
    H, P = 2 * degree + 1, IMG_HW * IMG_HW
    ev, harm, positions, channel = _decode_channel(dev)
    par = ev.params
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
    # bytes: the tables once, the harmonics once, the output once
    nbytes = tabs.numel() * 4 + harm.data.numel() * 4 + P * 2 * par.L * par.n * 4
    tab_gb = tabs.numel() * 4 / 1e9
    del tabs, flat, ev, harm, channel
    torch.cuda.empty_cache()
    share = _in_fresh_process(decode_channel_share)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"phase 5: decode harmonic expansion, one channel, {IMG_HW}x{IMG_HW}, n={par.n}, "
          f"{H} harmonics x {P} positions: first call (builds the {tab_gb:.3f} GB "
          f"weight tables: host encoding, upload, lift, one forward NTT over {H * P} rows) "
          f"{first_s:.3f} s host clock, of which the tables' NTT {tab_ms:.3f} ms (CUDA events); "
          f"from the cache {ms:.3f} ms per channel (CUDA events, 5 runs; the harmonics' forward "
          f"NTT included), {ms_io:.3f} ms with the output's inverse NTT, "
          f"{P * 1e3 / ms_io:.1f} output "
          f"positions x channels per s; NTT launches per channel {per_channel['ntt_forward']} "
          f"forward, {per_channel['ntt_inverse']} inverse; {share}; bound {bound_ms:.3f} ms by "
          f"bytes ({nbytes / 1e9:.3f} GB; {100 * bound_ms / ms_io:.1f} % of it reached); peak "
          f"device memory {peak / 2**30:.3f} GiB [{card}]", flush=True)

    par, pair = _pure_fhe_pair(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    _, bases = _count_ntt_by_base(pair, par.L)
    torch.cuda.synchronize()
    ms = time_ms(pair, 3)
    peak = torch.cuda.max_memory_allocated(dev)
    del pair
    torch.cuda.empty_cache()
    share = _in_fresh_process(pure_fhe_pair_share)
    print(f"phase 5: decode pure-FHE step, one pair, n={par.n}, t=2^24, degree 2, 16 positions, "
          f"relinearized (dbc 0): {ms:.3f} ms per pair (CUDA events, 3 runs); NTT launches per "
          f"pair by base {sorted(bases.items())}; {share}; peak device memory "
          f"{peak / 2**30:.3f} GiB [{card}]", flush=True)


def kernel_work(name, x, L, n, m) -> tuple:
    """(bytes, [FMA, ALU, either] int32 operations) that kernel ``name``
    needs for input x: x read once and the output (x's size) written once,
    plus the table rows it reads, which the benchmark's roofline leaves out;
    operations of the roofline's fewest-op graphs (the lazy graphs need
    m = lazy_bound_multiple > 0)."""
    assert m > 0, "the lazy op graphs need u32 headroom"
    xbytes = x.numel() * 4
    if name.startswith("ntt"):
        return 2 * xbytes + 2 * L * n * 4, ntt_ops(name, x.numel() // n, n)
    if name == "dct8x8":  # rows 0..12 and 22 of both tables; one DCT a thread
        return 2 * xbytes + 2 * 14 * L * n * 4, x.numel() // 64 * LAZY_DCT
    # the fused kernels, over x's blocks of 3 x 64 two-component ciphertexts
    blocks = x.numel() // (3 * 64 * 2 * L * n)
    return 2 * xbytes + 2 * 24 * L * n * 4, ycc_dct_ops(blocks, L, n, m)


def bound_times(nbytes, ops, sms, clock_hz) -> tuple:
    """(HBM ms, integer ms): the two terms of the roofline's bound_s, the
    bytes alone and the operations alone.  The bound is the larger."""
    return bound_s(nbytes, None, sms, clock_hz) * 1e3, bound_s(0, ops, sms, clock_hz) * 1e3


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
          f"{clock_hz / 1e6:.0f} MHz x ({LANE_OPS_PER_CLOCK[0]} FMA-pipe + "
          f"{LANE_OPS_PER_CLOCK[1]} ALU-pipe int32 lanes, {DISPATCH_PER_CLOCK} issued)",
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


def _run_module(args: list, cwd: str, timeout: int, stdin: bytes = None):
    """``python -m <args>`` as its user runs it, with the checkout importable
    and ``stdin`` (bytes) fed to it through a pipe; a non-zero exit raises
    with the end of its output."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p))
    r = subprocess.run([sys.executable, "-m"] + args, cwd=cwd, env=env, input=stdin,
                       capture_output=True, timeout=timeout)
    out, err = (b.decode(errors="replace")[-3000:] for b in (r.stdout, r.stderr))
    check(r.returncode == 0, f"{' '.join(args)} exited {r.returncode}:\n{out}\n{err}")


def phase_bench():
    """Phase 6: the measurement layer (fhetpu_torch.bench) on the card, each
    entry point as its user calls it: the headline at the four ring
    degrees, the noise sweep against fhetpu's committed artifact, and the
    --quick configurations of both sweeps."""
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
            nat = row.get("native28")
            check((nat is not None) == (n in (NATIVE_N, NATIVE_BIG))
                  and (nat is None or (nat["m"], nat["nb"]) == (2, row["nb"])),
                  f"headline n={n}: native28 block {nat}")
            if nat is not None:
                v = nat["variants"]["native28_lazy_nttfree"]
                print(f"phase 6a: headline n={n} native28 (L={nat['L']}, m={nat['m']}, "
                      f"{nat['bytes_in'] / 1e9:.2f} GB in, not SEAL-parity): lazy NTT-free min "
                      f"{v['ms_per_op_min']:.4f} ms of "
                      + ", ".join(f"{s:.4f}" for s in v["ms_per_op_samples"])
                      + f" ({nat['channel_blocks_per_s']:.1f} channel-blocks/s, "
                        f"{nat['vs_baseline']:.2f}x SEAL)", flush=True)
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
        _run_module(["fhetpu_torch.bench.benchmark", "--quick", "--out", logs,
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
        _run_module(["fhetpu_torch.bench.decode_sweep", "--quick", "--out", dout,
                     "--workdir", os.path.join(d, "decodework")], d, 900)
        stats = analyze.parse_log(os.path.join(dout, "sweep.log"))
        check({"Encryption", "Step", "Decryption", "RMSError"} <= set(stats),
              f"decode_sweep --quick: rows {sorted(stats)}")
        check(any(f.startswith("out_12_0.5.") for f in os.listdir(dout)),
              f"decode_sweep --quick wrote {os.listdir(dout)}")
        print(f"phase 6d: decode_sweep --quick (trusted, 48x48, n=4096, degree 12, delta 0.5) "
              f"in {time.perf_counter() - t0:.1f} s: Step {np.mean(stats['Step']):.6g} "
              f"ms/unit, RMSError {stats['RMSError'][0]}", flush=True)


SHARDS = 4  # logical shards on the one card in phase 7 (b) and (d)


def _file_bytes(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _decrypt_resize(keys: str, out, size: list, path: str):
    """The client's decryption of a [17, 17, 3, size, L, n] library output
    (written as a stream first): plaintext coefficients [17, 17, 3, n]."""
    from fhetpu_torch.cli import client_resize
    from fhetpu_torch.io import serial

    writer = serial.CtWriter(path, out.shape[3], out.shape[4], out.shape[5],
                             meta={"w": RESIZE_HW, "h": RESIZE_HW, "layout": "raster-rgb"})
    writer.append(out.cpu().numpy().reshape((-1,) + tuple(out.shape[3:])))
    writer.close()
    args = client_resize.parser().parse_args(["--recieve", "-i", path, "--keydir", keys] + size)
    return client_resize.recieve_arrays(args, keep_plain=True)[1]


def phase_sharded(dev, card):
    """Phase 7: fhetpu_torch.parallel on the card, every launch count set to
    0 just before each path and read just after: (a) the dp JPEG op and
    server_jpeg --sharded, (b) the sp halo resize and server_resize
    --sharded, (c) one NCCL process, (d) the machinery's own cost on one
    card, (e) distinct cards where the host has more than one."""
    import torch
    import torch.distributed as dist
    from fhetpu_torch.bfv.crypto import Encryptor, PublicKey
    from fhetpu_torch.bfv.encoder import FractionalEncoder
    from fhetpu_torch.bfv.evaluator import Evaluator
    from fhetpu_torch.bfv.params import BfvParams
    from fhetpu_torch.cli import client_jpeg, client_resize, server_jpeg, server_resize
    from fhetpu_torch.io import serial
    from fhetpu_torch.parallel import halo
    from fhetpu_torch.parallel.distributed import (distribute_ciphertexts,
                                                   global_block_sharding, init_distributed)
    from fhetpu_torch.parallel.mesh import make_mesh, map_blocks
    from fhetpu_torch.pipelines import resize as rz
    from fhetpu_torch.pipelines.jpeg_encode import server_compute_fn

    t_phase = time.perf_counter()
    cards = torch.cuda.device_count()
    img = np.random.default_rng(SEED).integers(0, 256, size=(IMG_HW, IMG_HW, 3),
                                               dtype=np.uint8)
    nb = (IMG_HW // 8) ** 2
    jpeg_kernels = ("server_ycc_dct", "server_ycc_dct_lazy", "dct8x8")
    with tempfile.TemporaryDirectory() as d:
        # (a) dp JPEG: the library op over 8 logical shards, then the CLI
        common = ["--keydir", os.path.join(d, "keys")]
        c2s = os.path.join(d, "c2s.bin")
        sargs = client_jpeg.parser().parse_args(["--send", "-c", c2s] + common)
        client_jpeg.send_array(sargs, img)
        check(sargs.cmod == 4096, f"client chose n={sargs.cmod}, expected 4096")
        par = BfvParams.create(n=sargs.cmod, t=sargs.pmod)
        encoder = FractionalEncoder(sargs.pmod, sargs.cmod)
        ev = Evaluator(par, encoder, device=dev)
        cts = _read_stream(c2s, nb * 192).reshape(nb, 3, 64, 2, par.L, par.n)
        x = torch.from_numpy(cts).to(dev)
        op = server_compute_fn(ev)
        want = op(x)
        mesh8 = make_mesh({"dp": 8}, [dev] * 8)
        reset_launches()
        got = map_blocks({ev.device: op}, x, mesh8)
        torch.cuda.synchronize()
        lib = read_launches()
        check(torch.equal(got, want), "dp JPEG op over 8 shards differs from the unsharded op")
        check(all(lib[k] == 8 for k in ("ntt_forward", "server_ycc_dct", "ntt_inverse")),
              f"dp JPEG op over 8 shards: not one launch per shard and kernel: {lib}")
        streams = {}
        for label, extra in (("unsharded", []), ("sharded", ["--sharded"]),
                             ("quantize", ["--quantize"]),
                             ("sharded quantize", ["--sharded", "--quantize"])):
            s2c = os.path.join(d, "s2c.bin")
            reset_launches()
            t0 = time.perf_counter()
            server_jpeg.main(["-i", c2s, "-c", s2c, "--device", "cuda"] + extra + common)
            secs = time.perf_counter() - t0
            cli = read_launches()
            dct = "dct8x8" if "quantize" in label else "server_ycc_dct"
            check(all(cli[k] > 0 for k in ("ntt_forward", dct, "ntt_inverse"))
                  and sum(cli.values()) == cli["ntt_forward"] + cli[dct] + cli["ntt_inverse"],
                  f"server_jpeg {label}: launches {cli}")
            streams[label] = _file_bytes(s2c)
            print(f"phase 7a: server_jpeg {label} over {cards if 'sharded' in label else 1} "
                  f"card(s), {IMG_HW}x{IMG_HW}, n={par.n}: {secs:.3f} s (host clock); "
                  f"launches {cli}", flush=True)
        for sharded, unsharded in (("sharded", "unsharded"), ("sharded quantize", "quantize")):
            check(streams[sharded] == streams[unsharded],
                  f"server_jpeg {sharded} stream differs from the {unsharded} one")
        print(f"phase 7a: dp JPEG op, {nb} blocks over 8 logical shards on {dev} (padded to "
              f"{-(-nb // 8) * 8}): bit-equal to the unsharded op; launches {lib}; "
              f"server_jpeg --sharded streams, default and --quantize, byte-equal to the "
              f"unsharded ones", flush=True)
        if cards > 1:  # (e) distinct cards
            mesh = make_mesh()
            reset_launches()
            got = map_blocks({c: server_compute_fn(ev.on(c)) for c in mesh.devices}, x, mesh)
            torch.cuda.synchronize()
            multi = read_launches()
            check(torch.equal(got, want), f"dp JPEG op over {cards} cards differs")
            print(f"phase 7e: dp JPEG op over {cards} distinct cards: bit-equal; launches "
                  f"{multi}", flush=True)

        # (c) one NCCL process: its block range, the op, a reduced checksum
        check(init_distributed(f"tcp://localhost:{_free_port()}", 1, 0, dev),
              "init_distributed refused explicit arguments")
        try:
            check(dist.get_backend() == "nccl", f"backend {dist.get_backend()}, not nccl")
            shard = global_block_sharding(nb)
            check((shard.lo, shard.hi, shard.device) == (0, nb, dev), f"block range {shard}")
            reset_launches()
            mine = op(distribute_ciphertexts(cts, shard))
            total = mine.to(torch.int64).sum().reshape(1)
            local = int(total)
            dist.all_reduce(total)
            dist_launches = read_launches()
            check(torch.equal(mine, want) and int(total) == local,
                  "the NCCL rank's op or its reduced checksum differs")
        finally:
            dist.destroy_process_group()
        print(f"phase 7c: init_distributed at world size 1 (nccl on {dev}): blocks "
              f"[{shard.lo}, {shard.hi}) on {shard.device}, op bit-equal, all_reduce checksum "
              f"{local}; launches {dist_launches}", flush=True)

        # (d) the dp machinery's own cost on the one card: CUDA events
        jpeg_ms = {"unsharded": time_ms(lambda: op(x), 5)}
        for D in (1, SHARDS, 8):
            mesh = make_mesh({"dp": D}, [dev] * D)
            jpeg_ms[f"D={D}"] = time_ms(lambda: map_blocks({ev.device: op}, x, mesh), 5)
        print(f"phase 7d: dp JPEG op, {nb} blocks, n={par.n}, one card: "
              + ", ".join(f"{k} {v:.3f} ms" for k, v in jpeg_ms.items())
              + f" (CUDA events, 5 runs; D=8 pads to {-(-nb // 8) * 8} blocks) [{card}]",
              flush=True)
        del x, want, got, mine
        torch.cuda.empty_cache()

    # (b) sp resize, 48x48 -> 17x17: bilinear with encrypted fracts (n=4096)
    size = ["--width", str(RESIZE_HW), "--height", str(RESIZE_HW)]
    with tempfile.TemporaryDirectory() as d:
        keys = os.path.join(d, "keys")
        common = ["--keydir", keys] + size
        c2s = os.path.join(d, "c2s.bin")
        sargs = client_resize.parser().parse_args(["--send", "-c", c2s] + common)
        client_resize.send_array(sargs, img)
        check(sargs.cmod == 4096, f"bilinear: client chose n={sargs.cmod}, not 4096")
        par = BfvParams.create(n=sargs.cmod, t=sargs.pmod)
        ev = Evaluator(par, FractionalEncoder(sargs.pmod, sargs.cmod), device=dev)
        enc = Encryptor(par, PublicKey(data=serial.load_public_key(
            os.path.join(keys, "pubkey.npz")), params=par))
        plains, cli = {}, {}
        for label, extra in (("tiles", []), ("sharded", ["--sharded"]),
                             ("tiles plain-fracts", ["--plain-fracts"]),
                             ("sharded plain-fracts", ["--sharded", "--plain-fracts"])):
            s2c = os.path.join(d, "s2c.bin")
            reset_launches()
            t0 = time.perf_counter()
            server_resize.main(["-i", c2s, "-c", s2c, "--device", "cuda"] + extra + common)
            secs = time.perf_counter() - t0
            cli[label] = read_launches()
            check(cli[label]["ntt_forward"] > 0 and cli[label]["ntt_inverse"] > 0
                  and all(cli[label][k] == 0 for k in jpeg_kernels),
                  f"server_resize {label}: launches {cli[label]}")
            if "plain" in label:
                streams[label] = _file_bytes(s2c)
            rargs = client_resize.parser().parse_args(["--recieve", "-i", s2c] + common)
            plains[label] = client_resize.recieve_arrays(rargs, keep_plain=True)[1]
            print(f"phase 7b: server_resize bilinear {label}, {IMG_HW}x{IMG_HW} -> "
                  f"{RESIZE_HW}x{RESIZE_HW}, n={par.n}: {secs:.3f} s (host clock); launches "
                  f"{cli[label]}", flush=True)
        check(streams["sharded plain-fracts"] == streams["tiles plain-fracts"],
              "server_resize --sharded --plain-fracts stream differs from the tile path's")
        src = torch.from_numpy(_read_stream(c2s, IMG_HW * IMG_HW * 3).reshape(
            IMG_HW, IMG_HW, 3, 2, par.L, par.n)).to(dev)
        mesh = make_mesh({"sp": SHARDS}, [dev] * SHARDS)
        reset_launches()
        torch.cuda.reset_peak_memory_stats(dev)
        out = halo.resize_sharded(ev, src, RESIZE_HW, RESIZE_HW, rz.BILINEAR, mesh,
                                  encryptor=enc)
        torch.cuda.synchronize()
        lib = read_launches()
        peak = torch.cuda.max_memory_allocated(dev)
        check(lib["ntt_forward"] > 0 and lib["ntt_inverse"] > 0
              and all(lib[k] == 0 for k in jpeg_kernels), f"sp resize: launches {lib}")
        plains["library"] = _decrypt_resize(keys, out, size, os.path.join(d, "lib.bin"))
        if cards > 1:  # (e) distinct cards
            out = halo.resize_sharded(ev, src, RESIZE_HW, RESIZE_HW, rz.BILINEAR,
                                      make_mesh({"sp": cards}), encryptor=enc)
            plains[f"{cards} cards"] = _decrypt_resize(keys, out, size,
                                                       os.path.join(d, "multi.bin"))
        for label, pl in plains.items():
            check(np.array_equal(pl, plains["tiles"]),
                  f"sp resize {label}: decrypts differently from the tile path")
        print(f"phase 7b: sp resize bilinear, encrypted fracts, {SHARDS} logical shards on "
              f"{dev}: decrypts to the tile path's polynomials, as do server_resize --sharded "
              f"with encrypted and plain fracts ({', '.join(plains)}); --plain-fracts stream "
              f"byte-equal; launches {lib}; peak device memory {peak / 2**30:.3f} GiB",
              flush=True)

        # (d) the sp machinery's own cost: the tile path against D = 1 and 4
        row_plan = rz.axis_plan(IMG_HW, RESIZE_HW, rz.BILINEAR)
        col_plan = rz.axis_plan(IMG_HW, RESIZE_HW, rz.BILINEAR)
        tiles = server_resize.tile_rows(row_plan, RESIZE_HW, 4)

        def tile_path():
            outs = []
            for y0, y1, lo, hi in tiles:
                rp = rz.AxisPlan(idx=row_plan.idx[y0:y1] - lo, fract=row_plan.fract[y0:y1])
                yops, xops = rz.make_fract_bundles(ev, rp, col_plan, rz.BILINEAR, encryptor=enc)
                outs.append(rz.resize_tile(ev, src[lo:hi], rp, col_plan, yops, xops,
                                           rz.BILINEAR, False))
            return outs

        resize_ms = {"tiles": time_ms(tile_path, 2)}
        for D in (1, SHARDS):
            mesh = make_mesh({"sp": D}, [dev] * D)
            resize_ms[f"D={D}"] = time_ms(lambda: halo.resize_sharded(
                ev, src, RESIZE_HW, RESIZE_HW, rz.BILINEAR, mesh, encryptor=enc), 2)
        print(f"phase 7d: bilinear resize, encrypted fracts, {IMG_HW}x{IMG_HW} -> "
              f"{RESIZE_HW}x{RESIZE_HW}, n=4096, one card: "
              + ", ".join(f"{k} {v:.3f} ms" for k, v in resize_ms.items())
              + f" (CUDA events over the whole call, host fract encryption included, 2 runs; "
                f"{len(tiles)} tiles of 4 rows; D={SHARDS} computes "
                f"{halo.plan_shards(row_plan, IMG_HW, RESIZE_HW, SHARDS).H2p} padded rows) "
                f"[{card}]", flush=True)
        del src, out
        torch.cuda.empty_cache()

    # (b) bicubic with plain fracts at n=8192 and the gather shape at 2048,
    # on random residues: residue-equal to the unsharded tile path
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 7)
    for mode_name, n, (H, W, H2, W2), D in (("bicubic", 8192, (IMG_HW, IMG_HW, RESIZE_HW,
                                                                RESIZE_HW), SHARDS),
                                            ("bicubic gather", 2048, (32, 8, 4, 5), 8)):
        par = BfvParams.create(n=n)
        ev = Evaluator(par, FractionalEncoder(par.t, n), device=dev)
        src = rand_residues((H, W, 3, 2), par.q_primes, n, gen, dev)
        row_plan, col_plan = rz.axis_plan(H, H2, rz.BICUBIC), rz.axis_plan(W, W2, rz.BICUBIC)
        g = halo.plan_shards(row_plan, H, H2, D)
        check(g.gather == (D == 8), f"{mode_name}: plan gather={g.gather}")
        t0 = time.perf_counter()
        want = []
        for y0, y1, lo, hi in server_resize.tile_rows(row_plan, H2, 4):
            rp = rz.AxisPlan(idx=row_plan.idx[y0:y1] - lo, fract=row_plan.fract[y0:y1])
            yops, xops = rz.make_fract_bundles(ev, rp, col_plan, rz.BICUBIC)
            want.append(rz.resize_tile(ev, src[lo:hi], rp, col_plan, yops, xops, rz.BICUBIC,
                                       True))
        want = torch.cat(want)
        torch.cuda.synchronize()
        t_tiles = time.perf_counter() - t0
        reset_launches()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        got = halo.resize_sharded(ev, src, H2, W2, rz.BICUBIC, make_mesh({"sp": D}, [dev] * D))
        torch.cuda.synchronize()
        t_sharded = time.perf_counter() - t0
        lib = read_launches()
        peak = torch.cuda.max_memory_allocated(dev)
        check(lib["ntt_forward"] > 0 and lib["ntt_inverse"] > 0
              and all(lib[k] == 0 for k in jpeg_kernels), f"{mode_name}: launches {lib}")
        e = max_abs_err(got, want)
        check(got.shape == want.shape and e == 0, f"{mode_name}: sharded differs by {e}")
        print(f"phase 7b: sp resize {mode_name}, plain fracts, {H}x{W} -> {H2}x{W2}, n={n}, "
              f"{D} logical shards (Hp {g.Hp}, h_up {g.h_up}, h_dn {g.h_dn}, gather {g.gather})"
              f": residue-equal to the tile path; sharded {t_sharded:.3f} s, tiles "
              f"{t_tiles:.3f} s (host clock, first calls); launches {lib}; peak device memory "
              f"{peak / 2**30:.3f} GiB", flush=True)
        del src, want, got
        torch.cuda.empty_cache()
    print(f"phase 7: {time.perf_counter() - t_phase:.1f} s (host clock)", flush=True)


NATIVE_N = 8192  # the ring degree where the native chain raises the lazy kernel's m from 1 to 2
NATIVE_BIG = 16384  # where the SEAL chain refuses the lazy kernel and the native one takes it
NATIVE_BIG_NB = 4  # 4 x 3 x 64 x 2 x 16 x 16384 x 4 B = 1.61 GB in, as at every n
BENCH_CORE_ONLY = "ntt_sweep,ntt_fwd,ntt_inv,behz,relinearize,linear,harmonics_order16"
BENCH_CORE_TIMEOUT = 300


def phase_native_fast(dev, gen, errs, card):
    """Phase 8: the modules of the port's last slice on the card, every
    launch count set to 0 just before each path and read just after, every
    comparison exact: (a) the 48x48 image on the native n=8192 chain
    through the lazy JPEG op; (b) the lazy kernel at n=16384 on the native
    chain; (c) bench.core."""
    import torch
    from fhetpu_torch.bfv import crypto
    from fhetpu_torch.bfv.encoder import FractionalEncoder
    from fhetpu_torch.bfv.evaluator import Evaluator
    from fhetpu_torch.bfv.params import BfvParams
    from fhetpu_torch.core import ntt_kernel, server_kernel
    from fhetpu_torch.io import images
    from fhetpu_torch.pipelines.jpeg_encode import server_compute_fn

    t_phase = time.perf_counter()
    # (a) the image on the native n=8192 chain, NTT kernels in and out
    par = BfvParams.create_native(n=NATIVE_N)
    encoder = FractionalEncoder(par.t, par.n)
    ev = Evaluator(par, encoder, device=dev)
    m = server_kernel.lazy_bound_multiple(ev)
    seal_m = server_kernel.lazy_bound_multiple(Evaluator(BfvParams.create(n=NATIVE_N), device=dev))
    check((m, seal_m) == (2, 1), f"native n={NATIVE_N}: m={m}, SEAL chain m={seal_m}")
    img = np.random.default_rng(SEED).integers(0, 256, size=(IMG_HW, IMG_HW, 3), dtype=np.uint8)
    nb = (IMG_HW // 8) ** 2
    kg = crypto.KeyGenerator(par, seed=SEED)
    blocks = np.stack([images.split_blocks(img[..., c].astype(np.float64)) for c in range(3)],
                      axis=1)
    t0 = time.perf_counter()
    cts = crypto.Encryptor(par, kg.public_key(), seed=SEED + 1).encrypt_batch(
        encoder.encode_batch(blocks).reshape(-1, par.n))
    t_enc = time.perf_counter() - t0
    x = torch.from_numpy(cts.reshape(nb, 3, 64, 2, par.L, par.n)).to(dev)
    op = server_compute_fn(ev, fused_lazy=True)
    reset_launches()
    out = op(x)
    torch.cuda.synchronize()
    lazy_path = read_launches()
    check(all(lazy_path[k] > 0 for k in ("ntt_forward", "server_ycc_dct_lazy", "ntt_inverse"))
          and lazy_path["server_ycc_dct"] == 0,
          f"native lazy JPEG op: launches {lazy_path}")
    t0 = time.perf_counter()
    plain = crypto.Decryptor(par, kg.secret).decrypt_batch(
        out.cpu().numpy().reshape(-1, 2, par.L, par.n)).reshape(nb, 3, 64, par.n)
    t_dec = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = _golden(encoder, img)
    t_gold = time.perf_counter() - t0
    check(np.array_equal(plain, want),
          f"native n={NATIVE_N} lazy JPEG op: decrypted coefficients differ from the golden oracle")
    print(f"phase 8a: native chain n={par.n} (L={par.L}, primes <= "
          f"{max(p.bit_length() for p in par.q_primes)} bits, lazy m={m} against the SEAL "
          f"chain's {seal_m}), {IMG_HW}x{IMG_HW} image: lazy JPEG op, NTT kernels in and out, "
          f"decrypts to exactly the golden oracle; launches {lazy_path}; host encryption "
          f"{t_enc:.3f} s, decryption {t_dec:.3f} s, golden oracle {t_gold:.3f} s", flush=True)
    del x, out, ev
    torch.cuda.empty_cache()

    # (b) the lazy kernel at n=16384 on the native chain, 1.61 GB of random residues
    par = BfvParams.create_native(n=NATIVE_BIG)
    ev = Evaluator(par, device=dev)
    m = server_kernel.lazy_bound_multiple(ev)
    check(m == 2, f"native n={NATIVE_BIG}: m={m}")
    st = ev.server_state(dev)
    x = rand_residues((NATIVE_BIG_NB, 3, 64, 2), par.q_primes, par.n, gen, dev)
    reset_launches()
    lazy = server_kernel.server_ycc_dct_fused(ev, x, lazy=True)
    torch.cuda.synchronize()
    launches = read_launches()["server_ycc_dct_lazy"]
    e = max_abs_err(lazy, server_kernel.server_ycc_dct_lazy_plain(x, st, m))
    errs["server_ycc_dct_lazy"] = max(errs["server_ycc_dct_lazy"], e)
    check(e == 0, f"lazy kernel vs plain at native n={NATIVE_BIG}: {e}")
    check(max_abs_err(lazy, server_kernel.server_ycc_dct_fused(ev, x)) == 0,
          f"lazy kernel vs strict kernel at native n={NATIVE_BIG}")
    del lazy
    polys = x[0, 0].reshape(-1, par.L, par.n)  # 128 polynomials of the native q
    fk = ntt_kernel.ntt_forward(polys, st.ntt)
    ik = ntt_kernel.ntt_inverse(fk, st.ntt)
    ef = max_abs_err(fk, ntt_kernel.ntt_plain(polys, st.ntt))
    ei = max_abs_err(ik, ntt_kernel.intt_plain(fk, st.ntt))
    errs["ntt_forward"], errs["ntt_inverse"] = (max(errs["ntt_forward"], ef),
                                                max(errs["ntt_inverse"], ei))
    check(ef == 0 and ei == 0 and max_abs_err(ik, polys) == 0,
          f"NTT kernels vs plain on the native q at n={NATIVE_BIG}: {ef}, {ei}")
    torch.cuda.empty_cache()
    clock_hz = float(smi("clocks.max.sm").split()[0]) * 1e6
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    k_ms = time_ms(lambda: server_kernel.server_ycc_dct_fused(ev, x, lazy=True), 10)
    s_ms = time_ms(lambda: server_kernel.server_ycc_dct_fused(ev, x), 10)
    nbytes, ops = kernel_work("server_ycc_dct_lazy", x, par.L, par.n, m)
    t_bytes, t_ops = bound_times(nbytes, ops, sms, clock_hz)
    b_ms, b_by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    print(f"phase 8b: native chain n={par.n} (L={par.L}), nb={NATIVE_BIG_NB} "
          f"({x.numel() * 4 / 1e9:.3f} GB in): lazy kernel (m={m}) bit-equal to its plain "
          f"version and to the strict kernel, {launches} launch; NTT kernels on the native q "
          f"bit-equal to plain, roundtrip exact; lazy kernel {k_ms:.3f} ms, strict kernel "
          f"{s_ms:.3f} ms (CUDA events, 10 runs); bound {b_ms:.3f} ms by {b_by} (HBM "
          f"{t_bytes:.3f} ms, integer {t_ops:.3f} ms; {100 * b_ms / k_ms:.1f} % of it reached) "
          f"[{card}]", flush=True)
    del x, st, ev
    torch.cuda.empty_cache()

    # (c) bench.core as its user runs it, under its own timeout
    labels = ("ntt_fwd_kernel", "ntt_inv_kernel", "behz_multiply", "relinearize",
              "linear_plainfract", "harmonics_order16")
    with tempfile.TemporaryDirectory() as d:
        out_path = os.path.join(d, "bench_core_torch.json")
        t0 = time.perf_counter()
        _run_module(["fhetpu_torch.bench.core", "--only", BENCH_CORE_ONLY, "--out", out_path],
                    d, BENCH_CORE_TIMEOUT)
        with open(out_path) as f:
            res = json.load(f)
    secs = time.perf_counter() - t0
    check(set(labels) <= set(res["ops"]) and set(res["ntt_sweep"]) == {"16", "64", "256", "1024"}
          and all(set(r) == {"kernel"} for r in res["ntt_sweep"].values()),
          f"bench.core: sections {sorted(res['ops'])}, sweep {res['ntt_sweep']}")
    print(f"phase 8c: bench.core --only {BENCH_CORE_ONLY} rc 0 in {secs:.1f} s, every section "
          f"present; {res['device']}; NTT launches {res['ntt_launches']}", flush=True)
    for B, row in res["ntt_sweep"].items():
        print(f"phase 8c: ntt_sweep B={B} (n={res['n']}, L={res['L']}): " + "; ".join(
            f"{col} {v['us_per_call']:.2f} us, {v['ntts_per_s']:.1f} NTTs/s, "
            f"{v['achieved_gb_per_s']:.2f} of {v['peak_gb_per_s']} GB/s" for col, v in row.items()),
            flush=True)
    for label in labels:
        print(f"phase 8c: {label}: " + ", ".join(f"{k} {v:.6g}" if isinstance(v, float) else
                                               f"{k} {v}" for k, v in res["ops"][label].items()),
              flush=True)
    print(f"phase 8: {time.perf_counter() - t_phase:.1f} s (host clock)", flush=True)


NAIVE_NS = (2048, 16384)  # phase 9b: the ring degrees of the naive-product check
NAIVE_NONZERO = 16  # non-zero coefficients of the sparse factor
SWEEP_BATCHES = (16, 64, 256)  # phase 9c: polynomials x L per launch, as bench.core sweeps
SWEEP_REPS = 20
L2_FLUSH_BYTES = 128 << 20  # written between profiled launches: over twice the 50 MB L2
SLEEP_CYCLES = 20_000_000  # ~10 ms at 1.98 GHz: longer than the host takes to enqueue a sweep


def _kernel_device_us(prof, name: str) -> tuple:
    """(launches, mean device us per launch) of the CUDA kernels whose
    profiler name holds ``name``; (0, 0.0) if the profiler saw none."""
    import torch

    count, us = 0, 0.0
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA and name in evt.key:
            us += _self_device_us(evt)
            count += evt.count
    return count, (us / count if count else 0.0)


def _events_behind_sleep(fn, pre, reps: int) -> float:
    """Mean device us per call of fn from CUDA events recorded around each
    call (pre() runs before each, outside the events), all enqueued while a
    sleep kernel holds the stream: the card reaches each call after the
    host has enqueued it, so the host's enqueue time falls outside the
    events."""
    import torch

    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(reps)]
    torch.cuda._sleep(SLEEP_CYCLES)
    for start, stop in pairs:
        pre()
        start.record()
        fn()
        stop.record()
    torch.cuda.synchronize()
    return 1e3 * sum(start.elapsed_time(stop) for start, stop in pairs) / reps


def phase_last_helpers(dev, gen, errs, card):
    """Phase 9: the last slice's functions on the card and the NTT kernels
    at the batches resize, decode and bench.core launch them with: (a)
    make_server against server_compute_fn, default and --quantize, each
    driven with the launch counts set to 0 just before it and read just
    after; (b) the NTT kernels' product against the naive negacyclic
    convolution, prime by prime; (c) the NTT kernels' device time
    (torch.profiler) at B = 16, 64 and 256 beside their bound."""
    import torch
    from fhetpu_torch.bfv.evaluator import Evaluator
    from fhetpu_torch.bfv.params import BfvParams
    from fhetpu_torch.codec.jpeg import ZIGZAG, build_quant_tables
    from fhetpu_torch.core import modops, ntt, ntt_kernel
    from fhetpu_torch.pipelines.jpeg_encode import make_server, server_compute_fn

    t_phase = time.perf_counter()
    # (a) make_server on phase 5's input: n = 4096, nb = 64, coefficient form
    par = BfvParams.create(n=TIMING_N)
    ev = Evaluator(par, device=dev)
    quant = build_quant_tables(0)[0][ZIGZAG].astype(np.float64)
    x = rand_residues((TIMING_NB, 3, 64, 2), par.q_primes, par.n, gen, dev)
    for label, q, runs, idle in (
            ("default", None, ("ntt_forward", "server_ycc_dct", "ntt_inverse"),
             ("server_ycc_dct_lazy", "dct8x8")),
            ("--quantize", quant, ("ntt_forward", "dct8x8", "ntt_inverse"),
             ("server_ycc_dct", "server_ycc_dct_lazy"))):
        want = server_compute_fn(ev, apply_quantize=q is not None, quant=q)(x)
        reset_launches()
        got = make_server(ev, q is not None, q)(x)
        torch.cuda.synchronize()
        path = read_launches()
        check(torch.equal(got, want), f"make_server {label} differs from server_compute_fn")
        check(all(path[k] > 0 for k in runs) and all(path[k] == 0 for k in idle),
              f"make_server {label}: launches {path}")
        print(f"phase 9a: make_server {label}, n={par.n} nb={TIMING_NB}, coefficient form: "
              f"bit-equal to server_compute_fn; launches {path}", flush=True)
        del want, got
    del x, ev
    torch.cuda.empty_cache()

    # (b) the NTT kernels' product against the O(n^2) golden model
    rng = np.random.default_rng(SEED)
    for n in NAIVE_NS:
        tables = BfvParams.create(n=n).tables_q
        dt = ntt_kernel.device_tables(tables, dev)
        L = len(tables.primes)
        a = np.zeros((L, n), np.uint32)
        for li, p in enumerate(tables.primes):
            hot = rng.choice(n, size=NAIVE_NONZERO, replace=False)
            hot[:2] = (0, n - 1)  # the wrap-around terms
            a[li, hot] = rng.integers(1, p, size=NAIVE_NONZERO, dtype=np.uint64)
        b = rand_residues((), tables.primes, n, gen, dev)
        a_dev = torch.from_numpy(a).to(dev)
        reset_launches()
        fa, fb = ntt_kernel.ntt_forward(a_dev, dt), ntt_kernel.ntt_forward(b, dt)
        pw = modops.to_u32(modops.mulmod(modops.to_i64(fa), modops.to_i64(fb),
                                         modops.to_i64(dt.p).reshape(L, 1)))
        prod = ntt_kernel.ntt_inverse(pw, dt)
        torch.cuda.synchronize()
        path = read_launches()
        ef = max(max_abs_err(fa, ntt_kernel.ntt_plain(a_dev, dt)),
                 max_abs_err(fb, ntt_kernel.ntt_plain(b, dt)))
        ei = max_abs_err(prod, ntt_kernel.intt_plain(pw, dt))
        errs["ntt_forward"] = max(errs["ntt_forward"], ef)
        errs["ntt_inverse"] = max(errs["ntt_inverse"], ei)
        check(ef == 0 and ei == 0,
              f"NTT kernels vs plain on the naive-product inputs at n={n}: {ef}, {ei}")
        check(path["ntt_forward"] == 2 and path["ntt_inverse"] == 1,
              f"naive-product check at n={n}: launches {path}")
        t0 = time.perf_counter()
        host_b, host_prod = b.cpu().numpy(), prod.cpu().numpy()
        for li, p in enumerate(tables.primes):
            want = ntt.negacyclic_convolve_naive(a[li], host_b[li], p)
            check(np.array_equal(host_prod[li], want),
                  f"NTT kernels' product != naive convolution at n={n}, prime {li} ({p})")
        print(f"phase 9b: n={n} q (L={L}): ntt_forward -> pointwise mulmod -> ntt_inverse on "
              f"the card equals negacyclic_convolve_naive prime by prime ({NAIVE_NONZERO} "
              f"non-zero coefficients in a per prime, b dense; naive model "
              f"{time.perf_counter() - t0:.1f} s of host); launches {path}", flush=True)
        del fa, fb, pw, prod, b, a_dev
    torch.cuda.empty_cache()

    # (c) device time of the NTT kernels at small batches, in a fresh process
    for line in _in_fresh_process(ntt_small_batch_times, dev, card):
        print(line, flush=True)
    print(f"phase 9: {time.perf_counter() - t_phase:.1f} s (host clock)", flush=True)


def ntt_small_batch_times(dev, card: str) -> list:
    """Phase 9c's lines: each NTT kernel's device us per launch at n = 4096,
    L = 4 and B = SWEEP_BATCHES, L2 flushed and warm, from torch.profiler
    and from CUDA events behind a sleep kernel, beside its bound.  Runs in
    its own process, so that the profiler starts fresh."""
    import torch
    from fhetpu_torch.bfv.params import BfvParams
    from fhetpu_torch.core import ntt_kernel

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 9)
    clock_hz = float(smi("clocks.max.sm").split()[0]) * 1e6
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    tables = BfvParams.create(n=TIMING_N).tables_q
    dt = ntt_kernel.device_tables(tables, dev)
    L, n = len(tables.primes), tables.n
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    lines = []
    for B in SWEEP_BATCHES:
        x = rand_residues((B,), tables.primes, n, gen, dev)
        fx = ntt_kernel.ntt_forward(x, dt)
        for name, fn, arg in (("ntt_forward", ntt_kernel.ntt_forward, x),
                              ("ntt_inverse", ntt_kernel.ntt_inverse, fx)):
            fn(arg, dt)  # warm-up
            torch.cuda.synchronize()
            prof_us, seen, event_us = {}, {}, {}
            for l2, pre in (("flushed", lambda: flush.fill_(1)), ("warm", lambda: None)):
                with _profiled() as prof:
                    for _ in range(SWEEP_REPS):
                        pre()
                        fn(arg, dt)
                seen[l2], prof_us[l2] = _kernel_device_us(prof, "ntt_kernel")
                event_us[l2] = _events_behind_sleep(lambda: fn(arg, dt), pre, SWEEP_REPS)
            nbytes, ops = kernel_work(name, x, L, n, 1)
            t_bytes, t_ops = bound_times(nbytes, ops, sms, clock_hz)
            data_us = 2 * x.numel() * 4 / HBM_BYTES_PER_S * 1e6
            b_us, b_by = (1e3 * t_bytes, "bytes") if t_bytes >= t_ops else (1e3 * t_ops,
                                                                           "operations")
            check(all(v == SWEEP_REPS for v in seen.values()),
                  f"phase 9c {name} B={B}: torch.profiler saw {seen} of {SWEEP_REPS} launches")
            profiled = (f"torch.profiler {prof_us['flushed']:.3f} / {prof_us['warm']:.3f} "
                        f"(all {SWEEP_REPS} launches seen; {100 * b_us / prof_us['flushed']:.1f} "
                        f"% / {100 * b_us / prof_us['warm']:.1f} % of the bound)")
            lines.append(
                f"phase 9c: {name} n={n} L={L} B={B} ({x.numel() * 4 / 1e6:.3f} MB in), "
                f"device us per launch, L2 flushed / warm: {profiled}; CUDA events behind a "
                f"sleep kernel {event_us['flushed']:.3f} / {event_us['warm']:.3f} "
                f"({SWEEP_REPS} launches); bound {b_us:.3f} us by {b_by} (HBM "
                f"{1e3 * t_bytes:.3f} us with the twiddle tables, {data_us:.3f} us for "
                f"2*4*B*L*n bytes alone; integer {1e3 * t_ops:.3f} us) [{card}]")
    return lines


PIPE_TIMEOUT = 300  # each phase-10 server process
# kernel families in a torch.profiler trace, by the names nvcc gives the kernels
TRACE_KERNELS = {"ntt_forward": r"ntt_kernel<(true|\(bool\)1)|ntt_kernelILb1",
                 "ntt_inverse": r"ntt_kernel<(false|\(bool\)0)|ntt_kernelILb0",
                 "server_ycc_dct": r"server_ycc_dct_strict_kernel",
                 "server_ycc_dct_lazy": r"server_ycc_dct_lazy_kernel",
                 "dct8x8": r"dct8x8_kernel",
                 "behz_floor_convert": r"behz_floor_convert_kernel",
                 "behz_extend": r"behz_extend_kernel",
                 "behz_tensor": r"behz_tensor_kernel",
                 "harmonic_expand": r"harmonic_expand_kernel"}


@contextlib.contextmanager
def feed_fifo(path: str, data: bytes):
    """A FIFO at path that a thread feeds with data once a reader opens it."""
    import threading

    os.mkfifo(path)

    def feed():
        with contextlib.suppress(BrokenPipeError), open(path, "wb") as f:
            f.write(data)

    t = threading.Thread(target=feed, daemon=True)
    t.start()
    try:
        yield path
    finally:
        if t.is_alive():  # no reader came, or it stopped early: let the writer go
            os.close(os.open(path, os.O_RDONLY | os.O_NONBLOCK))
        t.join(60)
        check(not t.is_alive(), f"the writer of {path} never finished")


def _trace_kernels(profile_dir: str) -> dict:
    """Launches per kernel family in the one torch.profiler trace a server
    wrote with --profile-dir, and the number of device kernels in all."""
    traces = [f for f in os.listdir(profile_dir) if f.startswith("trace-")]
    check(len(traces) == 1, f"{profile_dir} holds {traces}, not one trace")
    with open(os.path.join(profile_dir, traces[0])) as f:
        names = [e.get("name", "") for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "kernel"]
    out = {k: sum(bool(re.search(pat, name)) for name in names)
           for k, pat in TRACE_KERNELS.items()}
    out["all"] = len(names)
    check(out["all"] > 0, f"torch.profiler saw no device kernel in {traces[0]}")
    return out


def phase_pipes(work):
    """Phase 10: the port's CLIs reading their input from a pipe, as fhetpu's
    do, on the stream files phase 4 wrote:
    a. python -m fhetpu_torch.cli.server_jpeg --device cuda -i <FIFO fed by a
       thread> on 4a's stream: byte-equal to 4a's output from the file; its
       --profile-dir trace shows both NTT kernels and the fused kernel;
    b. python -m fhetpu_torch.cli.server_decode --device cuda -i /dev/stdin
       with 4i's harmonic stream piped in: decrypts to 4i's pixels; its
       trace shows both NTT kernels and no JPEG kernel;
    c. client_jpeg --recieve (run_recieve, the CLI's path) on 4a's output
       from a FIFO and from the file: the same RMSError line and JFIF."""
    import io

    from fhetpu_torch.cli import client_decode, client_jpeg

    t_phase = time.perf_counter()
    img = np.random.default_rng(SEED).integers(0, 256, size=(IMG_HW, IMG_HW, 3),
                                               dtype=np.uint8)
    jpeg, dec = os.path.join(work, "jpeg"), os.path.join(work, "decode")
    jpeg_kernels = ("server_ycc_dct", "server_ycc_dct_lazy", "dct8x8")
    with tempfile.TemporaryDirectory() as d:
        # (a) server_jpeg from a FIFO
        c2s = _file_bytes(os.path.join(jpeg, "c2s.bin"))
        s2c = _file_bytes(os.path.join(jpeg, "s2c_strict.bin"))
        out, prof = os.path.join(d, "s2c_fifo.bin"), os.path.join(d, "trace_jpeg")
        t0 = time.perf_counter()
        with feed_fifo(os.path.join(d, "c2s.fifo"), c2s) as fifo:
            _run_module(["fhetpu_torch.cli.server_jpeg", "-i", fifo, "-c", out,
                         "--chunk-blocks", "64", "--device", "cuda", "--keydir",
                         os.path.join(jpeg, "keys"), "--profile-dir", prof], d, PIPE_TIMEOUT)
        secs = time.perf_counter() - t0
        ran = _trace_kernels(prof)
        check(_file_bytes(out) == s2c, "server_jpeg from a FIFO: its stream differs from 4a's")
        check(all(ran[k] > 0 for k in ("ntt_forward", "server_ycc_dct", "ntt_inverse")),
              f"server_jpeg from a FIFO: kernels in its trace {ran}")
        print(f"phase 10a: python -m fhetpu_torch.cli.server_jpeg --device cuda -i <FIFO> on "
              f"4a's stream ({len(c2s) / 1e6:.1f} MB fed by a thread): byte-equal to 4a's "
              f"output from the file; {secs:.3f} s (host clock: process start, reading, op, "
              f"writing, profiler); kernels in its --profile-dir trace {ran}", flush=True)

        # (b) server_decode from /dev/stdin through a pipe
        keys = ["--keydir", os.path.join(dec, "keys")]
        c2s = _file_bytes(os.path.join(dec, "c2s.bin"))
        out, prof = os.path.join(d, "s2c_stdin.bin"), os.path.join(d, "trace_decode")
        t0 = time.perf_counter()
        _run_module(["fhetpu_torch.cli.server_decode", "-i", "/dev/stdin", "-c", out,
                     "--device", "cuda", "--profile-dir", prof] + keys, d, PIPE_TIMEOUT, stdin=c2s)
        secs = time.perf_counter() - t0
        ran = _trace_kernels(prof)
        pix = {}
        for src, path in (("file", os.path.join(dec, "s2c.bin")), ("stdin", out)):
            rargs = client_decode.parser().parse_args(["--recieve", "-i", path] + keys)
            pix[src] = client_decode.to_pixels(client_decode.recieve_arrays(rargs))
        check(pix["stdin"].shape == (IMG_HW, IMG_HW, 3)
              and np.array_equal(pix["stdin"], pix["file"]),
              "server_decode from /dev/stdin: pixels differ from 4i's")
        check(ran["ntt_forward"] > 0 and ran["ntt_inverse"] > 0
              and all(ran[k] == 0 for k in jpeg_kernels),
              f"server_decode from /dev/stdin: kernels in its trace {ran}")
        same = _file_bytes(out) == _file_bytes(os.path.join(dec, "s2c.bin"))
        print(f"phase 10b: python -m fhetpu_torch.cli.server_decode --device cuda -i /dev/stdin "
              f"on 4i's harmonic stream ({len(c2s) / 1e6:.1f} MB through a pipe): decrypts to "
              f"4i's {IMG_HW}x{IMG_HW} pixels (stream {'byte-equal' if same else 'not byte-equal'} "
              f"to 4i's); {secs:.3f} s (host clock, as 10a); kernels in its trace {ran}",
              flush=True)

        # (c) client_jpeg --recieve from a FIFO
        keys = ["--keydir", os.path.join(jpeg, "keys")]
        rms, jfif, secs = {}, {}, {}
        for src in ("file", "fifo"):
            jfif[src] = os.path.join(d, f"out_{src}.jpg")
            buf = io.StringIO()
            with contextlib.ExitStack() as stack:
                path = (os.path.join(jpeg, "s2c_strict.bin") if src == "file" else
                        stack.enter_context(feed_fifo(os.path.join(d, "s2c.fifo"), s2c)))
                rargs = client_jpeg.parser().parse_args(
                    ["--recieve", "-i", path, "-o", jfif[src]] + keys)
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(buf):
                    client_jpeg.run_recieve(rargs, img)
                secs[src] = time.perf_counter() - t0
            rms[src] = [ln for ln in buf.getvalue().splitlines() if ln.startswith("RMSError,")]
        check(len(rms["file"]) == 1 and rms["fifo"] == rms["file"],
              f"client_jpeg --recieve from a FIFO: {rms['fifo']}, from the file {rms['file']}")
        check(_file_bytes(jfif["fifo"]) == _file_bytes(jfif["file"]),
              "client_jpeg --recieve from a FIFO: its JPEG differs from the file run's")
        print(f"phase 10c: client_jpeg --recieve on 4a's output from a FIFO: {rms['fifo'][0]} "
              f"and a JFIF byte-equal to the file run's; {secs['fifo']:.3f} s from the FIFO, "
              f"{secs['file']:.3f} s from the file (host clock)", flush=True)
    print(f"phase 10: {time.perf_counter() - t_phase:.1f} s (host clock)", flush=True)


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
    behz_times = phase_behz(dev, gen, errs, card)
    behz_times["behz_tensor"] = phase_tensor(dev, gen, errs, card)
    expand_times = phase_expand(dev, gen, errs, card)
    with tempfile.TemporaryDirectory() as work:  # phase 4's streams, read again in phase 10
        launches = phase_main_paths(dev, work)
        launches.update(phase_resize_paths(dev))
        launches["harmonic_expand"] = phase_decode_paths(dev, work)
        _, times = phase_timing(dev, gen, errs, card)
        times.update(behz_times)
        times["harmonic_expand"] = expand_times
        phase_resize_timing(dev, gen, card)
        phase_decode_timing(dev, card)
        phase_bench()
        phase_sharded(dev, card)
        phase_native_fast(dev, gen, errs, card)
        phase_last_helpers(dev, gen, errs, card)
        phase_pipes(work)

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
