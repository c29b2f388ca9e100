"""Host-side BFV key generation, encryption and decryption (NumPy).

A JAX-free copy of the clients' part of ``fhetpu/bfv/crypto.py``: the
trusted client stays on the host and secret material never touches the
device.  The code and the order of random draws are unchanged, so
``KeyGenerator(seed=s)`` (public and relinearization keys) and
``Encryptor(seed=s)`` give the same keys and ciphertexts as fhetpu's.  The
noise-budget measurement is not carried over yet.

Ciphertext layout everywhere: ``uint32[size, L, n]`` (or batched
``[B, size, L, n]``), coefficient domain unless stated otherwise.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from .. import native
from ..core import modops, ntt
from .encoder import Plaintext
from .params import BfvParams, MAX_ERROR_MULT


def _rns_lift_signed(small: np.ndarray, primes) -> np.ndarray:
    """Map small signed coeffs [..., n] -> RNS uint32 [..., L, n]."""
    out = []
    for p in primes:
        out.append(np.mod(small.astype(np.int64), int(p)).astype(np.uint32))
    return np.stack(out, axis=-2)


def _lift_forward_i8(u: np.ndarray, tables, nlib=None) -> np.ndarray:
    """NTT(lift(u)) for small signed int8 [..., n] -> uint32 [..., L, n],
    fused in one native pass (no int64 temporaries) when available."""
    if nlib is None:
        nlib = native.lib()
    L, n = len(tables.primes), tables.n
    if nlib is not None and u.shape[-1] == n:
        import ctypes

        u32p = ctypes.POINTER(ctypes.c_uint32)
        i8p = ctypes.POINTER(ctypes.c_int8)
        u_c = np.ascontiguousarray(u, dtype=np.int8)
        batch = int(np.prod(u.shape[:-1], dtype=np.int64))
        out = np.empty(u.shape[:-1] + (L, n), dtype=np.uint32)
        nlib.fastntt_lift_forward_i8(
            u_c.ctypes.data_as(i8p), out.ctypes.data_as(u32p), batch, L, n,
            tables.psi_br.ctypes.data_as(u32p),
            tables.psi_br_shoup.ctypes.data_as(u32p),
            np.ascontiguousarray(tables.p.reshape(-1)).ctypes.data_as(u32p),
            native.default_threads(),
        )
        return out
    return ntt.np_ntt(
        _rns_lift_signed(u.astype(np.int64), [int(p) for p in tables.primes]),
        tables,
    )


def centered_lift_plain(coeffs_mod_t: np.ndarray, params: BfvParams) -> np.ndarray:
    """[0,t) plaintext coeffs [..., n] -> centered RNS uint32 [..., L, n].

    SEAL's plain_upper_half lift: coefficients >= (t+1)/2 map to c - t
    (i.e. c + (p_i - t) mod p_i), keeping noise growth symmetric.
    """
    thr = params.plain_upper_half_threshold
    c = coeffs_mod_t.astype(np.int64)
    centered = np.where(c >= thr, c - params.t, c)
    return _rns_lift_signed(centered, params.q_primes)


@dataclass
class SecretKey:
    small: np.ndarray  # int8 [n] in {-1,0,1}
    params: BfvParams
    _ntt_pows: dict = field(default_factory=dict, repr=False)

    def ntt_power(self, k: int) -> np.ndarray:
        """NTT(s^k) over the q base, uint32 [L, n]; cached."""
        if k not in self._ntt_pows:
            t = self.params.tables_q
            if k == 0:
                raise ValueError("s^0 never needed")
            if k == 1:
                rns = _rns_lift_signed(self.small.astype(np.int64), self.params.q_primes)
                self._ntt_pows[1] = ntt.np_ntt(rns, t)
            else:
                prev = self.ntt_power(k - 1)
                s1 = self.ntt_power(1)
                p = t.p.astype(np.uint64).reshape(-1, 1)
                self._ntt_pows[k] = (
                    prev.astype(np.uint64) * s1.astype(np.uint64) % p
                ).astype(np.uint32)
        return self._ntt_pows[k]


@dataclass
class PublicKey:
    data: np.ndarray  # uint32 [2, L, n], coefficient domain
    params: BfvParams

    def ntt(self) -> np.ndarray:
        return ntt.np_ntt(self.data, self.params.tables_q)


@dataclass
class RelinKeys:
    """Evaluation keys for relinearizing s^k components (k >= 2) down to
    degree 1, using per-RNS-limb decomposition with optional 2^dbc
    sub-digits.  keys[k] has shape uint32 [L*D, 2, L, n] (NTT domain),
    digit order (limb i, sub-digit d): row (i, d) encrypts
    2^(d*dbc) * w_i * s^k where w_i is the CRT basis element (1 mod p_i,
    0 elsewhere).  digit_bits == 0 means one digit per limb (D = 1).
    """

    keys: dict  # k -> np.ndarray [L*D, 2, L, n]
    digit_bits: int
    params: BfvParams

    @property
    def n_subdigits(self) -> int:
        if not self.digit_bits:
            return 1
        maxbits = max(int(p).bit_length() for p in self.params.q_primes)
        return -(-maxbits // self.digit_bits)


class KeyGenerator:
    def __init__(self, params: BfvParams, seed: Optional[int] = None):
        self.params = params
        self.rng = np.random.default_rng(seed)
        n = params.n
        self.secret = SecretKey(
            small=self.rng.integers(-1, 2, size=n, dtype=np.int8), params=params
        )
        self._public: Optional[PublicKey] = None

    def _gaussian(self, shape) -> np.ndarray:
        sig = self.params.sigma
        bound = int(MAX_ERROR_MULT * sig)
        e = np.rint(self.rng.normal(0.0, sig, size=shape)).astype(np.int64)
        return np.clip(e, -bound, bound)

    def _uniform_rns(self, shape_prefix) -> np.ndarray:
        """Uniform element(s) of R_q in RNS NTT-agnostic (coeff) domain."""
        cols = []
        for p in self.params.q_primes:
            cols.append(
                self.rng.integers(0, int(p), size=shape_prefix + (self.params.n,), dtype=np.uint64).astype(np.uint32)
            )
        return np.stack(cols, axis=-2)

    def public_key(self) -> PublicKey:
        """pk = (-(a*s + e), a), computed in NTT domain."""
        if self._public is not None:
            return self._public
        par = self.params
        t = par.tables_q
        p = t.p.astype(np.uint64).reshape(-1, 1)
        a = self._uniform_rns(())  # [L, n] coeff domain
        a_ntt = ntt.np_ntt(a, t)
        s_ntt = self.secret.ntt_power(1)
        as_ntt = (a_ntt.astype(np.uint64) * s_ntt.astype(np.uint64) % p).astype(
            np.uint32
        )
        as_coeff = ntt.np_intt(as_ntt, t)
        e = _rns_lift_signed(self._gaussian((par.n,)), par.q_primes)
        pk0 = (p - (as_coeff.astype(np.uint64) + e.astype(np.uint64)) % p) % p
        self._public = PublicKey(
            data=np.stack([pk0.astype(np.uint32), a]), params=par
        )
        return self._public

    def relin_keys(self, max_power: int = 2, digit_bits: Optional[int] = None) -> RelinKeys:
        """Evaluation keys for s^2..s^max_power.

        Decomposition: per RNS limb i, optionally split into ceil(bits(p_i)/
        digit_bits) sub-digits of 2^digit_bits.  digit_bits=None means one
        digit per limb (the common RNS keyswitch).
        """
        par = self.params
        t = par.tables_q
        L, n = par.L, par.n
        dbc = int(digit_bits or 0)
        if dbc < 0 or dbc > 30:
            raise ValueError("digit_bits must be in [0, 30] (primes are < 2^30)")
        maxbits = max(int(q).bit_length() for q in par.q_primes)
        D = -(-maxbits // dbc) if dbc else 1
        p = t.p.astype(np.uint64).reshape(-1, 1)
        s_ntt = self.secret.ntt_power(1)
        keys = {}
        # digit factors: for limb i, w_i = qhat_i * qhat_inv_i (the CRT
        # basis element that is 1 mod p_i, 0 elsewhere); with dbc, sub-digit
        # d of limb i carries the extra plaintext factor 2^(d*dbc) mod p_i
        for k in range(2, max_power + 1):
            sk_ntt = self.secret.ntt_power(k)
            digs = []
            for i in range(L):
                for d in range(D):
                    # key pair: (-(a s + e) + 2^(d*dbc) * w_i * s^k, a), NTT
                    a = self._uniform_rns(())
                    a_ntt = ntt.np_ntt(a, t)
                    e_ntt = ntt.np_ntt(
                        _rns_lift_signed(self._gaussian((n,)), par.q_primes), t
                    )
                    b = (
                        p
                        - (
                            a_ntt.astype(np.uint64) * s_ntt.astype(np.uint64) % p
                            + e_ntt.astype(np.uint64)
                        )
                        % p
                    ) % p
                    pow2 = (1 << (d * dbc)) % int(par.q_primes[i]) if dbc else 1
                    b[i] = (
                        b[i] + np.uint64(pow2) * sk_ntt[i].astype(np.uint64)
                    ) % p[i]
                    digs.append(np.stack([b.astype(np.uint32), a_ntt]))
            keys[k] = np.stack(digs)  # [L*D, 2, L, n]
        return RelinKeys(keys=keys, digit_bits=dbc, params=par)


class Encryptor:
    def __init__(self, params: BfvParams, public_key: PublicKey, seed: Optional[int] = None):
        self.params = params
        self.pk_ntt = public_key.ntt()
        self.rng = np.random.default_rng(seed)

    def encrypt_batch(self, coeffs_mod_t: np.ndarray, chunk: int = 256) -> np.ndarray:
        """Encrypt plaintext coeff arrays [B, n] (mod t) -> uint32 [B, 2, L, n].

        ct = (pk0*u + e0 + Delta*m~, pk1*u + e1) with fresh ternary u and
        gaussian e per ciphertext; all polynomial products via batched NTT.
        """
        par = self.params
        t = par.tables_q
        B = coeffs_mod_t.shape[0]
        consts = par.consts
        out = np.empty((B, 2, par.L, par.n), dtype=np.uint32)
        sig = par.sigma
        bound = int(MAX_ERROR_MULT * sig)
        nlib = native.lib()
        p64, mu64, sh64 = modops.np_barrett_u64([int(x) for x in par.q_primes])
        for lo in range(0, B, chunk):
            hi = min(lo + chunk, B)
            nb = hi - lo
            u = self.rng.integers(-1, 2, size=(nb, par.n), dtype=np.int8)
            u_ntt = _lift_forward_i8(u, t, nlib)
            # [nb, 2, L, n] = pk_ntt[None] * u_ntt[:, None] (native kernels)
            prod = np.stack(
                [ntt.np_pointwise_mulmod(u_ntt, self.pk_ntt[c], t) for c in (0, 1)],
                axis=1,
            )
            ct = ntt.np_intt(prod, t)
            e = np.clip(
                np.rint(self.rng.normal(0.0, sig, size=(nb, 2, par.n))
                        .astype(np.float32)),
                -bound, bound,
            ).astype(np.int32)
            mc = coeffs_mod_t[lo:hi].astype(np.int64)
            # the native kernel takes int32 centered messages: |m| <= t/2,
            # so t must fit
            if par.t >= (1 << 31):
                raise ValueError(
                    f"plain modulus t={par.t} >= 2^31 overflows the int32 "
                    "centered-message path of encrypt_batch")
            m_centered = np.where(
                mc >= par.plain_upper_half_threshold, mc - par.t, mc
            ).astype(np.int32)
            if nlib is not None:
                import ctypes

                ct = np.ascontiguousarray(ct, dtype=np.uint32)
                u32p = ctypes.POINTER(ctypes.c_uint32)
                i32p = ctypes.POINTER(ctypes.c_int32)
                e_c = np.ascontiguousarray(e)
                m_c = np.ascontiguousarray(m_centered)
                delta = np.ascontiguousarray(
                    consts.delta_mod_q.reshape(-1).astype(np.uint32)
                )
                p_arr = np.ascontiguousarray(t.p.reshape(-1))
                nlib.fastntt_encrypt_finish(
                    ct.ctypes.data_as(u32p), e_c.ctypes.data_as(i32p),
                    m_c.ctypes.data_as(i32p), nb, par.L, par.n,
                    delta.ctypes.data_as(u32p), p_arr.ctypes.data_as(u32p),
                    native.default_threads(),
                )
                out[lo:hi] = ct
            else:
                ct = modops.np_addmod_b(
                    ct, _rns_lift_signed(e.astype(np.int64), par.q_primes), p64
                )
                dm = modops.np_mulmod_b(
                    _rns_lift_signed(m_centered.astype(np.int64), par.q_primes),
                    consts.delta_mod_q, p64, mu64, sh64,
                )
                ct[:, 0] = modops.np_addmod_b(ct[:, 0], dm, p64)
                out[lo:hi] = ct.astype(np.uint32)
        return out

    def encrypt(self, plain: Plaintext) -> np.ndarray:
        return self.encrypt_batch(plain.coeffs[None])[0]


class Decryptor:
    def __init__(self, params: BfvParams, secret_key: SecretKey):
        self.params = params
        self.sk = secret_key

    def _dot_secret(self, cts: np.ndarray, ntt_form: bool = False) -> np.ndarray:
        """x = sum_j ct_j s^j mod q for ct [..., size, L, n] -> [..., L, n].
        ntt_form=True skips the forward NTTs (stream already in evaluation
        domain).  c0 needs no domain round-trip: by NTT linearity
        x = c0 + INTT(sum_{j>=1} NTT(c_j) * s^j)."""
        par = self.params
        t = par.tables_q
        size = cts.shape[-3]
        p32 = t.p.reshape(1, -1, 1)  # [1, L, 1] uint32; sums < 2^31 fit u32

        def fwd(a):
            a = np.ascontiguousarray(a)
            return a if ntt_form else ntt.np_ntt(a, t)

        acc = None
        for j in range(1, size):
            cj = fwd(cts[..., j, :, :])
            prod = ntt.np_pointwise_mulmod(cj, self.sk.ntt_power(j), t)
            if acc is None:
                acc = prod
            else:
                acc = acc + prod
                acc = np.where(acc >= p32, acc - p32, acc)
        c0 = np.ascontiguousarray(cts[..., 0, :, :])
        if acc is None:  # degenerate size-1 "ciphertext": x = c0
            return ntt.np_intt(c0, t) if ntt_form else c0
        if ntt_form:
            # stream already in evaluation domain: sum there, one INTT
            acc = c0 + acc
            return ntt.np_intt(np.where(acc >= p32, acc - p32, acc), t)
        x = c0 + ntt.np_intt(acc, t)
        return np.where(x >= p32, x - p32, x)

    def _sk_scaled_power(self, j: int) -> np.ndarray:
        """s^j (NTT form) pre-scaled by qhat_inv per limb -- folds the CRT
        decode constant into the secret-key operand.  Cached per power."""
        cache = getattr(self, "_sk_scaled", None)
        if cache is None:
            cache = self._sk_scaled = {}
        if j not in cache:
            par = self.params
            p64 = par.tables_q.p.astype(np.uint64).reshape(-1, 1)
            qi = par.consts.qhat_inv_mod_q.astype(np.uint64).reshape(-1, 1)
            s = self.sk.ntt_power(j).astype(np.uint64)
            cache[j] = ((s * qi) % p64).astype(np.uint32)
        return cache[j]

    def _z_fused(self, cts: np.ndarray, ntt_form: bool, nlib) -> np.ndarray:
        """z = qhat_inv * (sum_j ct_j s^j) mod q for [..., size, L, n] via
        the native single-pass kernels (decrypt fast path)."""
        import ctypes

        par = self.params
        t = par.tables_q
        u32p = ctypes.POINTER(ctypes.c_uint32)
        size = cts.shape[-3]
        p32 = t.p.reshape(1, -1, 1)
        if ntt_form:
            # sum in the evaluation domain (c0 included), one inverse
            # transform with qhat_inv folded into the n^-1 scaling
            acc = np.ascontiguousarray(cts[..., 0, :, :])
            for j in range(1, size):
                prod = ntt.np_pointwise_mulmod(
                    np.ascontiguousarray(cts[..., j, :, :]),
                    self.sk.ntt_power(j), t)
                acc = acc + prod
                acc = np.where(acc >= p32, acc - p32, acc)
            return ntt.np_intt_scaled(
                acc, t, par.consts.qhat_inv_mod_q.reshape(-1))
        acc = None
        for j in range(1, size):
            cj = ntt.np_ntt(np.ascontiguousarray(cts[..., j, :, :]), t)
            prod = ntt.np_pointwise_mulmod(cj, self._sk_scaled_power(j), t)
            if acc is None:
                acc = prod
            else:
                acc = acc + prod
                acc = np.where(acc >= p32, acc - p32, acc)
        if acc is None:
            z = np.zeros(cts.shape[:-3] + (par.L, par.n), np.uint32)
        else:
            z = ntt.np_intt(acc, t)  # already carries qhat_inv via s'
        # z += c0 * qhat_inv, one native pass
        c0 = np.ascontiguousarray(cts[..., 0, :, :])
        qi = par.consts.qhat_inv_mod_q.astype(np.uint64).reshape(-1)
        p64 = t.p.astype(np.uint64).reshape(-1)
        qi_sh = (qi << np.uint64(32)) // p64
        z = np.ascontiguousarray(z)
        flat = z.reshape(-1, par.L, par.n)
        nlib.fastntt_scalar_muladd(
            z.ctypes.data_as(u32p), c0.ctypes.data_as(u32p),
            flat.shape[0], par.L, par.n,
            np.ascontiguousarray(qi.astype(np.uint32)).ctypes.data_as(u32p),
            np.ascontiguousarray(
                qi_sh.astype(np.uint32)).ctypes.data_as(u32p),
            np.ascontiguousarray(t.p.reshape(-1)).ctypes.data_as(u32p),
            native.default_threads(),
        )
        return z

    def decrypt_batch(self, cts: np.ndarray, ntt_form: bool = False,
                      chunk: int = 128) -> np.ndarray:
        """uint32 [B, size, L, n] -> plaintext coeffs int64 [B, n] in [0,t).

        m = round(t * x / q) mod t computed limb-wise:
        z_i = x_i * qhat_i^-1 mod p_i;  t*x/q == sum_i z_i * t / p_i (mod t),
        summed in float64 with an exact big-int fallback for coefficients
        whose fractional part lands within 1e-6 of 0.5.  Chunked over the
        batch to keep the working set in the host cache.  With the native
        library, qhat_inv folds into the secret-key operand / the INTT's
        n^-1 scaling and the CRT tail runs in C++; the output is the same.
        """
        par = self.params
        if cts.ndim == 4 and cts.shape[0] > chunk:
            return np.concatenate([
                self.decrypt_batch(cts[lo:lo + chunk], ntt_form, chunk)
                for lo in range(0, cts.shape[0], chunk)
            ])
        nlib = native.lib()
        if nlib is not None:
            import ctypes

            z = self._z_fused(cts, ntt_form, nlib)
            flat = np.ascontiguousarray(z.reshape(-1, par.L, par.n))
            B = flat.shape[0]
            out_m = np.empty((B, par.n), np.int64)
            risky = np.empty((B, par.n), np.uint8)
            recip = np.asarray([1.0 / float(p) for p in par.q_primes],
                               dtype=np.float64)
            u32p = ctypes.POINTER(ctypes.c_uint32)
            nlib.fastntt_crt_decode(
                flat.ctypes.data_as(u32p), B, par.L, par.n,
                ctypes.c_uint64(par.t),
                recip.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                out_m.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                risky.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                native.default_threads(),
            )
            if risky.any():
                # exact big-int CRT for coefficients near the .5 boundary:
                # x = sum_l z_l * qhat_l mod q (z already carries qhat_inv)
                qhat = par.consts.qhat
                q = par.q
                for b, c in np.argwhere(risky):
                    xi = sum(int(flat[b, l, c]) * qhat[l]
                             for l in range(par.L)) % q
                    out_m[b, c] = (par.t * xi + q // 2) // q % par.t
            return out_m.reshape(cts.shape[:-3] + (par.n,))
        consts = par.consts
        x = self._dot_secret(cts, ntt_form)  # [B, L, n]
        t_tab = par.tables_q
        qhat_inv_poly = np.broadcast_to(
            consts.qhat_inv_mod_q.astype(np.uint32), (par.L, par.n)
        )
        z = ntt.np_pointwise_mulmod(x, np.ascontiguousarray(qhat_inv_poly), t_tab)
        w = z * np.uint64(par.t)
        # multiply by precomputed 1/p instead of dividing: absolute error
        # ~1e-11, far inside the 1e-6 exact big-int fallback window below
        recip = getattr(self, "_recip_q", None)
        if recip is None:
            recip = self._recip_q = 1.0 / np.asarray(
                [float(p) for p in par.q_primes], dtype=np.float64
            ).reshape(-1, 1)
        v = (w.astype(np.float64) * recip).sum(axis=-2)
        m = np.floor(v + 0.5)
        frac = v - np.floor(v)
        risky = np.abs(frac - 0.5) < 1e-6
        if risky.any():
            q = par.q
            for idx in np.argwhere(risky):
                b, c = (int(idx[0]), int(idx[1])) if x.ndim == 3 else (0, int(idx[0]))
                xi = _crt_reconstruct(x[b, :, c] if x.ndim == 3 else x[:, c], par)
                num = par.t * xi
                m_val = (num + q // 2) // q  # round half up
                m[(b, c) if x.ndim == 3 else (c,)] = float(m_val % par.t)
        return np.mod(m.astype(np.int64), par.t)


def _crt_reconstruct(limbs: np.ndarray, par: BfvParams) -> int:
    """Exact big-int CRT of one coefficient from its q-base limbs."""
    consts = par.consts
    q = par.q
    acc = 0
    for i, pi in enumerate(par.q_primes):
        zi = int(limbs[i]) * int(consts.qhat_inv_mod_q[i, 0]) % int(pi)
        acc += zi * consts.qhat[i]
    return acc % q
