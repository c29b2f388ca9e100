"""fhetpu_torch host modules and NTT against fhetpu: twiddle tables, BFV
constants, modular helpers, noise estimate, ring-degree chooser, stream
format, and the NTT kernel's plain version against fhetpu's Pallas NTT in
interpret mode.  Every comparison is exact (tolerance 0); inputs come from
np.random.default_rng."""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fhetpu.bfv import chooser as f_chooser
from fhetpu.bfv import noise as f_noise
from fhetpu.bfv.encoder import FractionalEncoder
from fhetpu.bfv.params import BfvParams as FBfvParams
from fhetpu.core import modops as f_modops
from fhetpu.core import ntt as f_ntt
from fhetpu.io import serial as f_serial

from fhetpu_torch.bfv import chooser, noise
from fhetpu_torch.bfv.params import BfvParams
from fhetpu_torch.core import build, modops, ntt, ntt_kernel
from fhetpu_torch.io import serial

torch.set_num_threads(2)

T = 1 << 14
_TABLE_FIELDS = ("p", "mu", "shift", "psi_br", "psi_br_shoup", "ipsi_br",
                 "ipsi_br_shoup", "n_inv", "n_inv_shoup")


def _residues(rng, primes, prefix, n):
    return np.stack(
        [rng.integers(0, int(p), size=tuple(prefix) + (n,), dtype=np.uint64)
         for p in primes], axis=-2).astype(np.uint32)


@pytest.mark.parametrize("n", [2048, 4096])
@pytest.mark.parametrize("base", ["tables_q", "tables_bsk"])
def test_ntt_tables_equal_fhetpu(n, base):
    ours = getattr(BfvParams.create(n=n, t=T), base)
    ref = getattr(FBfvParams.create(n=n, t=T), base)
    assert ours.primes == ref.primes and ours.logn == ref.logn
    for f in _TABLE_FIELDS:
        a, b = getattr(ours, f), getattr(ref, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f


@pytest.mark.parametrize("n", [2048, 4096])
def test_bfv_consts_equal_fhetpu(n):
    ours, ref = BfvParams.create(n=n, t=T), FBfvParams.create(n=n, t=T)
    assert (ours.q_primes, ours.b_primes, ours.m_sk) == (ref.q_primes, ref.b_primes, ref.m_sk)
    assert (ours.q, ours.delta, ours.noise_budget_max()) == (ref.q, ref.delta, ref.noise_budget_max())
    assert ours.describe() == ref.describe()
    a, b = ours.consts, ref.consts
    for f in ("qp", "qmu", "qshift", "bskp", "bskmu", "bskshift", "delta_mod_q",
              "delta_mod_q_shoup", "neg_t_mod_q", "t_mod_q", "qhat_inv_mod_q",
              "qhat_inv_mod_q_shoup"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    assert a.qhat == b.qhat


def test_modops_match_fhetpu():
    rng = np.random.default_rng(0)
    primes = BfvParams.create(n=4096, t=T).q_primes
    for got, want in zip(modops.barrett_params(primes), f_modops.barrett_params(primes)):
        assert np.array_equal(got, want)
    x = _residues(rng, primes, (16,), 64)
    y = _residues(rng, primes, (16,), 64)
    w = _residues(rng, primes, (), 64)
    p32 = np.asarray(primes, dtype=np.uint32).reshape(-1, 1)
    ws = modops.shoup(w, p32.astype(np.uint64))
    assert np.array_equal(ws, f_modops.shoup(w, p32.astype(np.uint64)))
    p64, mu64, sh64 = modops.np_barrett_u64(primes)
    assert np.array_equal(modops.np_mulmod_b(x, y, p64, mu64, sh64),
                          f_modops.np_mulmod_b(x, y, p64, mu64, sh64))
    assert np.array_equal(modops.np_addmod_b(x, y, p64), f_modops.np_addmod_b(x, y, p64))
    p0 = int(primes[0])
    for name in ("np_mulmod", "np_addmod", "np_submod"):
        a, b = x[:, 0], y[:, 0]
        assert np.array_equal(getattr(modops, name)(a, b, p0),
                              getattr(f_modops, name)(a, b, p0)), name

    # torch int64 ops against fhetpu's jnp ops, and the u32 boundary
    tx, ty = modops.to_i64(torch.from_numpy(x)), modops.to_i64(torch.from_numpy(y))
    tw, tws = torch.from_numpy(w.astype(np.int64)), torch.from_numpy(ws.astype(np.int64))
    tp = torch.from_numpy(p32.astype(np.int64))
    jx, jy, jp = jnp.asarray(x), jnp.asarray(y), jnp.asarray(p32)
    pairs = [
        (modops.addmod(tx, ty, tp), f_modops.addmod(jx, jy, jp)),
        (modops.submod(tx, ty, tp), f_modops.submod(jx, jy, jp)),
        (modops.negmod(tx, tp), f_modops.negmod(jx, jp)),
        (modops.mulmod_shoup(tx, tw, tws, tp),
         f_modops.mulmod_shoup(jx, jnp.asarray(w), jnp.asarray(ws), jp)),
    ]
    for got, want in pairs:
        assert np.array_equal(modops.to_u32(got).numpy(), np.asarray(want))
    assert modops.to_u32(tx).dtype == torch.uint32
    assert np.array_equal(modops.to_u32(tx).numpy(), x)


def test_host_ntt_matches_fhetpu():
    """np_ntt/np_intt (native path) and the NumPy staged path, both ways."""
    rng = np.random.default_rng(1)
    ours = BfvParams.create(n=2048, t=T).tables_q
    ref = FBfvParams.create(n=2048, t=T).tables_q
    x = _residues(rng, ours.primes, (3,), 2048)
    fx = f_ntt.np_ntt(x, ref)
    assert np.array_equal(ntt.np_ntt(x, ours), fx)
    assert np.array_equal(ntt._ntt_impl(x, ours), fx)
    assert np.array_equal(ntt.np_intt(fx, ours), x)
    assert np.array_equal(ntt._intt_impl(fx, ours), x)
    scale = np.asarray([3, 5], dtype=np.uint32)
    assert np.array_equal(ntt.np_intt_scaled(fx, ours, scale),
                          f_ntt.np_intt_scaled(fx, ref, scale))
    assert np.array_equal(ntt.np_pointwise_mulmod(x, fx[0], ours),
                          f_ntt.np_pointwise_mulmod(x, fx[0], ref))


def test_ntt_plain_matches_fhetpu_pallas_interpret():
    """ntt_plain/intt_plain, the NTT kernel's plain versions, against
    fhetpu's Pallas NTT in interpret mode on a batch of 8 at n=2048."""
    from fhetpu.core.pallas_ntt import make_ntt

    rng = np.random.default_rng(2)
    ref_tables = FBfvParams.create(n=2048, t=T).tables_q
    dt = ntt_kernel.device_tables(BfvParams.create(n=2048, t=T).tables_q, "cpu")
    x = _residues(rng, ref_tables.primes, (8,), 2048)
    fwd = make_ntt(ref_tables, forward=True, rows_per_block=2, interpret=True)
    inv = make_ntt(ref_tables, forward=False, rows_per_block=2, interpret=True)
    want_f = np.array(fwd(jnp.asarray(x)))
    got_f = ntt_kernel.ntt_plain(torch.from_numpy(x), dt)
    assert got_f.dtype == torch.uint32
    assert np.array_equal(got_f.numpy(), want_f)
    want_i = np.asarray(inv(jnp.asarray(want_f)))
    assert np.array_equal(ntt_kernel.intt_plain(torch.from_numpy(want_f), dt).numpy(), want_i)
    assert np.array_equal(want_i, x)


def test_device_ntt_dispatch_on_cpu():
    """core.ntt.ntt/intt on a CPU tensor run the plain version: equal to the
    host transform, on the Bsk base too, without counting a launch."""
    rng = np.random.default_rng(3)
    tables = BfvParams.create(n=4096, t=T).tables_bsk
    x = _residues(rng, tables.primes, (2, 2), 4096)
    before = (ntt_kernel.ntt_forward.launches, ntt_kernel.ntt_inverse.launches)
    fx = ntt.ntt(torch.from_numpy(x), tables)
    assert np.array_equal(fx.numpy(), ntt.np_ntt(x, tables))
    assert np.array_equal(ntt.intt(fx, tables).numpy(), x)
    assert (ntt_kernel.ntt_forward.launches, ntt_kernel.ntt_inverse.launches) == before


def test_wrappers_refuse_other_devices():
    """A tensor that is neither on the CPU nor on CUDA is refused, never
    silently moved to the plain version."""
    tables = BfvParams.create(n=2048, t=T).tables_q
    dt = ntt_kernel.device_tables(tables, "cpu")
    x = torch.empty((1, 2, 2048), dtype=torch.uint32, device="meta")
    with pytest.raises(ValueError):
        ntt_kernel.ntt_forward(x, dt)
    with pytest.raises(ValueError):
        ntt_kernel.ntt_inverse(x, dt)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "LIB_PATH", str(tmp_path / "libnone.so"))
    with pytest.raises(build.KernelBuildError, match="nvcc not found"):
        build.build()


_FAKE_NVCC = """#!/bin/sh
echo "$@" >> "{log}"
case "$*" in *fail.cu*) echo "fail.cu: error" >&2; exit 1;; esac
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then echo built > "$2"; fi
  shift
done
"""


def test_build_runs_one_nvcc_per_source_then_links(monkeypatch, tmp_path):
    """build() starts one nvcc -c per csrc/*.cu, links the objects into the
    library, removes them, and raises with the compiler's output when a
    source fails."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(_FAKE_NVCC.replace("{log}", str(tmp_path / "calls.log")))
    nvcc.chmod(0o755)
    monkeypatch.setenv("PATH", str(tmp_path))
    out = tmp_path / "out"
    monkeypatch.setattr(build, "BUILD_DIR", str(out))
    monkeypatch.setattr(build, "LIB_PATH", str(out / "lib.so"))
    assert build.build() == str(out / "lib.so")
    calls = (tmp_path / "calls.log").read_text().splitlines()
    sources = build._sources()
    assert len(sources) >= 3 and len(calls) == len(sources) + 1
    assert sorted(c.split(" -c ")[1].split()[0] for c in calls[:-1]) == sources
    assert " -shared " in calls[-1] and calls[-1].count(".o") == len(sources)
    assert os.listdir(out) == ["lib.so"]
    monkeypatch.setattr(build, "_sources", lambda: sources + [str(tmp_path / "fail.cu")])
    os.remove(out / "lib.so")
    with pytest.raises(build.KernelBuildError, match="fail.cu: error"):
        build.build()
    assert os.listdir(out) == []


@pytest.mark.parametrize("n", [2048, 4096])
@pytest.mark.parametrize("mean", [False, True])
def test_noise_estimate_matches_fhetpu(n, mean):
    enc = FractionalEncoder(T, n)
    got = noise.estimate_jpeg_pipeline(BfvParams.create(n=n, t=T), enc, mean=mean)
    want = f_noise.estimate_jpeg_pipeline(FBfvParams.create(n=n, t=T), enc, mean=mean)
    assert got.log2_noise == want.log2_noise
    assert got.budget_bits == want.budget_bits


@pytest.mark.parametrize("t", [1 << 14, 1 << 20])
def test_chooser_matches_fhetpu(t):
    got, want = chooser.jpeg_parameters(t=t), f_chooser.jpeg_parameters(t=t)
    assert (got.n, got.q_primes, got.t) == (want.n, want.q_primes, want.t)


def test_streams_byte_compatible(tmp_path):
    """The same chunks written by either package give identical bytes, and
    each package reads the other's stream."""
    rng = np.random.default_rng(4)
    chunks = [rng.integers(0, 1 << 27, size=(k, 2, 2, 64), dtype=np.uint32) for k in (3, 2)]
    meta = {"w": 16, "h": 8, "layout": "rgb-blocks", "ntt": False}
    paths = {}
    for name, mod in (("ours", serial), ("ref", f_serial)):
        paths[name] = str(tmp_path / f"{name}.bin")
        w = mod.CtWriter(paths[name], 2, 2, 64, meta=meta)
        for c in chunks:
            w.append(c)
        w.close()
    with open(paths["ours"], "rb") as a, open(paths["ref"], "rb") as b:
        assert a.read() == b.read()
    want = np.concatenate(chunks)
    for mod, path in ((serial, paths["ref"]), (f_serial, paths["ours"])):
        r = mod.CtReader(path)
        assert (r.count, r.meta) == (5, meta)
        assert np.array_equal(r.read(4), want[:4])
        assert np.array_equal(r.read(4), want[4:])
        assert r.read(4) is None
        r.close()
    serial.write_params_txt(str(tmp_path / "params.txt"), 16, 8, 3, T)
    assert f_serial.read_params_txt(str(tmp_path / "params.txt")) == (16, 8, 3, T)
