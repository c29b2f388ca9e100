"""Device-side BFV evaluator: the linear ops over batched ciphertext tensors.

Port of the linear part of ``fhetpu/bfv/evaluator.py``.  Every op is a
plain function of torch tensors ``[..., size, L, n]`` on ``self.device``;
the pipelines run in the NTT (evaluation) domain, where add/sub are
elementwise modular adds and multiply_plain is a Shoup pointwise multiply by
the NTT of the encoded constant.  Residues compute in int64 (see
``core/modops.py``); the NTT transforms take and return uint32, the type of
the stream and of the kernels.

Plaintext operands and relinearization keys are built once on the host
with NumPy, exactly as fhetpu builds them, and moved to each device once.
ct x ct multiplication is the BEHZ algorithm of ``rns.py``; relinearize,
multiply_many and exponentiate follow fhetpu's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..convert import server_arrays, server_state_from_numpy
from ..core import modops, ntt
from ..trace import span
from . import rns
from .crypto import centered_lift_plain
from .encoder import FractionalEncoder, Plaintext
from .params import BfvParams


@dataclass
class Ct:
    """Batched ciphertext: data [..., size, L, n] residues (uint32 or int64)."""

    data: torch.Tensor
    ntt_form: bool = False

    @property
    def size(self) -> int:
        return self.data.shape[-3]


@dataclass(frozen=True)
class DeviceOperand:
    """A PlainOperand's tables on one device, int64 [L, n]."""

    mul_ntt: torch.Tensor
    mul_ntt_shoup: torch.Tensor
    add_ntt: torch.Tensor
    add_coeff: torch.Tensor


class PlainOperand:
    """A plaintext constant prepared for device ops against NTT-form cts.

    mul_*: NTT(centered_lift(m)) with Shoup companions -- for multiply_plain.
    add_*: NTT(Delta * centered_lift(m)) -- for add_plain/sub_plain.
    The host arrays are numpy uint32 [L, n]; ``on(device)`` uploads them
    once per device.
    """

    def __init__(self, params: BfvParams, coeffs_mod_t: np.ndarray):
        t = params.tables_q
        consts = params.consts
        p64 = t.p.astype(np.uint64)
        lifted = centered_lift_plain(coeffs_mod_t, params)  # [L, n]
        m_ntt = ntt.np_ntt(lifted, t)
        self.mul_ntt = m_ntt
        self.mul_ntt_shoup = modops.shoup(m_ntt, p64)
        dm = (
            lifted.astype(np.uint64) * consts.delta_mod_q.astype(np.uint64) % p64
        ).astype(np.uint32)
        self.add_ntt = ntt.np_ntt(dm, t)
        self.add_coeff = dm
        self._on: dict = {}

    def on(self, device) -> DeviceOperand:
        device = torch.device(device)
        if device not in self._on:
            def up(a):
                return torch.from_numpy(a.astype(np.int64)).to(device)

            self._on[device] = DeviceOperand(
                up(self.mul_ntt), up(self.mul_ntt_shoup), up(self.add_ntt),
                up(self.add_coeff))
        return self._on[device]


class DeviceRelinKeys:
    """Relinearization keys (NTT domain) prepared for device use.

    ``host_rk`` is anything with ``keys`` ({k: uint32 [L*D, 2, L, n]}) and
    ``digit_bits``: a ``crypto.RelinKeys`` of either package, or the arrays
    of an ``evalkeys.npz``.  The digits per limb D come from the key's
    shape, as in fhetpu.  ``stacked(size, device)`` concatenates
    keys[2..size-1] along the digit axis in component order, matching the
    evaluator's flattened (component, limb, sub-digit) digit layout, and is
    uploaded once per (size, device) as int64.
    """

    def __init__(self, host_rk):
        self.keys = {k: np.ascontiguousarray(v) for k, v in host_rk.keys.items()}
        self.digit_bits = int(getattr(host_rk, "digit_bits", 0) or 0)
        any_key = next(iter(self.keys.values()))
        self.n_subdigits = any_key.shape[0] // any_key.shape[2]
        self._stacked: dict = {}

    def stacked(self, size: int, device) -> torch.Tensor:
        key = (size, torch.device(device))
        if key not in self._stacked:
            host = np.concatenate([self.keys[k] for k in range(2, size)], axis=0)
            self._stacked[key] = torch.from_numpy(host.astype(np.int64)).to(key[1])
        return self._stacked[key]


def canonical_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device without an index gets the
    current one, the index its tensors report, so per-device caches hit one
    key."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


class Evaluator:
    """Holds per-params constants on one device (the card unless the caller
    passes ``device="cpu"``); all methods are pure."""

    def __init__(self, params: BfvParams, encoder: Optional[FractionalEncoder] = None,
                 device="cuda"):
        self.params = params
        self.encoder = encoder or FractionalEncoder(params.t, params.n)
        self.device = canonical_device(device)
        self.p = torch.from_numpy(params.consts.qp.astype(np.int64)).to(self.device)  # [L,1]
        self.tables_q = params.tables_q
        self._plain_cache: dict = {}
        self._server_states: dict = {}
        self._rns_tool: Optional[rns.RnsTool] = None
        self._siblings = {self.device: self}

    def on(self, device) -> "Evaluator":
        """The evaluator of these params and encoder on ``device``: itself on
        its own device, else one sibling per device, built once, which
        shares the host-side operand cache (``encode``) and keeps its own
        device constants.  Sharded paths run each shard on its device's."""
        device = canonical_device(device)
        if device not in self._siblings:
            sib = Evaluator(self.params, self.encoder, device)
            sib._plain_cache, sib._siblings = self._plain_cache, self._siblings
            self._siblings[device] = sib
        return self._siblings[device]

    # ----- plaintext operand preparation (host, cached) ------------------

    def encode(self, value: float) -> PlainOperand:
        key = float(value)
        if key not in self._plain_cache:
            self._plain_cache[key] = PlainOperand(
                self.params, self.encoder.encode(value).coeffs
            )
        return self._plain_cache[key]

    def operand(self, plain: Plaintext) -> PlainOperand:
        """An operand for any plaintext (uncached); ``encode`` caches the
        encoder's constants."""
        return PlainOperand(self.params, plain.coeffs)

    def server_state(self, device=None):
        """The fused server kernel's tables (``convert.ServerState``) on
        ``device`` (default: the evaluator's), built once per device."""
        device = torch.device(device) if device is not None else self.device
        if device not in self._server_states:
            self._server_states[device] = server_state_from_numpy(
                server_arrays(self), device)
        return self._server_states[device]

    # ----- domain transforms ---------------------------------------------

    def transform_to_ntt(self, ct: Ct) -> Ct:
        if ct.ntt_form:
            return ct
        with span("bfv.evaluator.transform"):
            return Ct(ntt.ntt(modops.to_u32(ct.data), self.tables_q), True)

    def transform_from_ntt(self, ct: Ct) -> Ct:
        if not ct.ntt_form:
            return ct
        with span("bfv.evaluator.transform"):
            return Ct(ntt.intt(modops.to_u32(ct.data), self.tables_q), False)

    # ----- linear ops (domain-agnostic elementwise) ----------------------

    def _align(self, a: Ct, b: Ct):
        assert a.ntt_form == b.ntt_form, "mixed-domain ct/ct op"
        da, db = modops.to_i64(a.data), modops.to_i64(b.data)
        sa, sb = a.size, b.size
        if sa == sb:
            return da, db
        size = max(sa, sb)

        def pad(d, s):
            if s == size:
                return d
            zeros = torch.zeros(d.shape[:-3] + (size - s,) + d.shape[-2:],
                                dtype=d.dtype, device=d.device)
            return torch.cat([d, zeros], dim=-3)

        return pad(da, sa), pad(db, sb)

    def add(self, a: Ct, b: Ct) -> Ct:
        with span("bfv.evaluator.linear"):
            da, db = self._align(a, b)
            return Ct(modops.addmod(da, db, self.p), a.ntt_form)

    def sub(self, a: Ct, b: Ct) -> Ct:
        with span("bfv.evaluator.linear"):
            da, db = self._align(a, b)
            return Ct(modops.submod(da, db, self.p), a.ntt_form)

    def negate(self, a: Ct) -> Ct:
        with span("bfv.evaluator.linear"):
            return Ct(modops.negmod(modops.to_i64(a.data), self.p), a.ntt_form)

    def _plain_c0(self, a: Ct, op: PlainOperand, fn) -> Ct:
        dev = op.on(self.device)
        dm = dev.add_ntt if a.ntt_form else dev.add_coeff
        d = a.data.to(torch.int64, copy=True)
        d[..., 0, :, :] = fn(d[..., 0, :, :], dm, self.p)
        return Ct(d, a.ntt_form)

    def add_plain(self, a: Ct, op: PlainOperand) -> Ct:
        with span("bfv.evaluator.linear"):
            return self._plain_c0(a, op, modops.addmod)

    def sub_plain(self, a: Ct, op: PlainOperand) -> Ct:
        with span("bfv.evaluator.linear"):
            return self._plain_c0(a, op, modops.submod)

    def multiply_plain(self, a: Ct, op: PlainOperand) -> Ct:
        """Pointwise product with the cached NTT of the constant.  NTT-form
        cts multiply directly; coefficient-form cts bounce through the NTT
        (SEAL's Evaluator::multiply_plain does the same internally)."""
        with span("bfv.evaluator.multiply_plain"):
            dev = op.on(self.device)
            if a.ntt_form:
                return Ct(modops.mulmod_shoup(modops.to_i64(a.data), dev.mul_ntt,
                                              dev.mul_ntt_shoup, self.p), True)
            d = modops.to_i64(ntt.ntt(modops.to_u32(a.data), self.tables_q))
            d = modops.mulmod_shoup(d, dev.mul_ntt, dev.mul_ntt_shoup, self.p)
            return Ct(ntt.intt(modops.to_u32(d), self.tables_q), False)

    # ----- ciphertext-by-ciphertext multiplication (BEHZ) -----------------

    @property
    def rns_tool(self) -> rns.RnsTool:
        if self._rns_tool is None:
            self._rns_tool = rns.RnsTool(self.params, self.device)
        return self._rns_tool

    def multiply(self, a: Ct, b: Ct) -> Ct:
        """FV multiply; sizes compose (k1, k2) -> k1+k2-1; coefficient-form
        int64 result (SEAL 2.3 Evaluator::multiply, unrelinearized)."""
        with span("bfv.evaluator.multiply"):
            da = self.transform_from_ntt(a).data
            db = da if b is a else self.transform_from_ntt(b).data
            return Ct(rns.multiply(da, db, self.rns_tool), False)

    def square(self, a: Ct) -> Ct:
        return self.multiply(a, a)

    def relinearize(self, a: Ct, rk: DeviceRelinKeys) -> Ct:
        """Key-switch every component of degree >= 2 down to (c0, c1).

        Every (component k, limb i, sub-digit d) digit polynomial is built
        at once, goes through one batched NTT, is multiplied by its key and
        summed, and the sum goes through one inverse NTT.  With digit_bits
        (dbc) set on the keys, each limb splits into D sub-digits of 2^dbc;
        the shift runs on int64, since torch has no CPU uint32 shift."""
        size = a.size
        if size <= 2:
            return a
        da = modops.to_i64(self.transform_from_ntt(a).data)
        n = self.params.n
        dbc, D = rk.digit_bits, rk.n_subdigits
        comps = da[..., 2:, :, :]  # [..., K2, L, n]
        if dbc:
            mask = (1 << dbc) - 1
            digs = torch.stack([(comps >> (d * dbc)) & mask for d in range(D)],
                               dim=-2)  # [..., K2, L, D, n]
        else:
            digs = comps[..., None, :]  # [..., K2, L, 1, n]
        G = (size - 2) * self.params.L * D
        flat = digs.reshape(da.shape[:-3] + (G, 1, n))
        # each digit value (< p_i or < 2^dbc) reduced into every limb
        d_ntt = modops.to_i64(ntt.ntt(modops.to_u32(flat % self.p), self.tables_q))
        key = rk.stacked(size, self.device)  # [G, 2, L, n] NTT domain
        acc = None
        for g in range(G):
            term = modops.mulmod(d_ntt[..., g, None, :, :], key[g], self.p)
            acc = term if acc is None else acc + term
        acc = modops.to_i64(ntt.intt(modops.to_u32(acc % self.p), self.tables_q))
        return Ct(modops.addmod(da[..., :2, :, :], acc, self.p), False)

    def add_many(self, cts) -> Ct:
        """Sum of a list of ciphertexts (SEAL Evaluator::add_many)."""
        cts = list(cts)
        acc = cts[0]
        for c in cts[1:]:
            acc = self.add(acc, c)
        return acc

    def multiply_many(self, cts, rk: Optional[DeviceRelinKeys] = None) -> Ct:
        """Product of a list of ciphertexts (SEAL Evaluator::multiply_many),
        relinearized after each multiply when rk is given."""
        cts = list(cts)
        acc = cts[0]
        for c in cts[1:]:
            acc = self.multiply(acc, c)
            if rk is not None:
                acc = self.relinearize(acc, rk)
        return acc

    def exponentiate(self, a: Ct, exponent: int,
                     rk: Optional[DeviceRelinKeys] = None) -> Ct:
        """a^exponent by square-and-multiply (SEAL Evaluator::exponentiate),
        exponent >= 1; relinearizes after each multiply when rk is given."""
        if exponent < 1:
            raise ValueError("exponentiate requires exponent >= 1 (SEAL semantics)")
        result = None
        base = a
        e = exponent
        while True:
            if e & 1:
                result = base if result is None else self.multiply(result, base)
                if rk is not None and result.size > 2:
                    result = self.relinearize(result, rk)
            e >>= 1
            if e == 0:
                break
            base = self.square(base)
            if rk is not None and base.size > 2:
                base = self.relinearize(base, rk)
        return result

    # linear-combination fusion helper for pipeline graphs
    def lincomb(self, terms) -> Ct:
        """sum_i ct_i * const_i (consts pre-encoded PlainOperands or None
        for unit coefficient); all cts NTT-form, same size."""
        acc = None
        for ct, op in terms:
            d = modops.to_i64(ct.data)
            if op is not None:
                dev = op.on(self.device)
                d = modops.mulmod_shoup(d, dev.mul_ntt, dev.mul_ntt_shoup, self.p)
            acc = d if acc is None else modops.addmod(acc, d, self.p)
        return Ct(acc, True)
