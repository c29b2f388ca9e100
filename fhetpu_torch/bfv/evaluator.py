"""Device-side BFV evaluator: the linear ops over batched ciphertext tensors.

Port of the linear part of ``fhetpu/bfv/evaluator.py``.  Every op is a
plain function of torch tensors ``[..., size, L, n]`` on ``self.device``;
the pipelines run in the NTT (evaluation) domain, where add/sub are
elementwise modular adds and multiply_plain is a Shoup pointwise multiply by
the NTT of the encoded constant.  Residues compute in int64 (see
``core/modops.py``); the NTT transforms take and return uint32, the type of
the stream and of the kernels.

Plaintext operands are built once on the host with NumPy, exactly as
fhetpu builds them, and moved to each device once.  ct x ct multiply and
relinearization are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..convert import server_arrays, server_state_from_numpy
from ..core import modops, ntt
from .crypto import centered_lift_plain
from .encoder import FractionalEncoder
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


class Evaluator:
    """Holds per-params constants on one device (the card unless the caller
    passes ``device="cpu"``); all methods are pure."""

    def __init__(self, params: BfvParams, encoder: Optional[FractionalEncoder] = None,
                 device="cuda"):
        self.params = params
        self.encoder = encoder or FractionalEncoder(params.t, params.n)
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            # the index tensors report, so per-device caches hit one key
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.p = torch.from_numpy(params.consts.qp.astype(np.int64)).to(self.device)  # [L,1]
        self.tables_q = params.tables_q
        self._plain_cache: dict = {}
        self._server_states: dict = {}

    # ----- plaintext operand preparation (host, cached) ------------------

    def encode(self, value: float) -> PlainOperand:
        key = float(value)
        if key not in self._plain_cache:
            self._plain_cache[key] = PlainOperand(
                self.params, self.encoder.encode(value).coeffs
            )
        return self._plain_cache[key]

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
        return Ct(ntt.ntt(modops.to_u32(ct.data), self.tables_q), True)

    def transform_from_ntt(self, ct: Ct) -> Ct:
        if not ct.ntt_form:
            return ct
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
        da, db = self._align(a, b)
        return Ct(modops.addmod(da, db, self.p), a.ntt_form)

    def sub(self, a: Ct, b: Ct) -> Ct:
        da, db = self._align(a, b)
        return Ct(modops.submod(da, db, self.p), a.ntt_form)

    def negate(self, a: Ct) -> Ct:
        return Ct(modops.negmod(modops.to_i64(a.data), self.p), a.ntt_form)

    def _plain_c0(self, a: Ct, op: PlainOperand, fn) -> Ct:
        dev = op.on(self.device)
        dm = dev.add_ntt if a.ntt_form else dev.add_coeff
        d = a.data.to(torch.int64, copy=True)
        d[..., 0, :, :] = fn(d[..., 0, :, :], dm, self.p)
        return Ct(d, a.ntt_form)

    def add_plain(self, a: Ct, op: PlainOperand) -> Ct:
        return self._plain_c0(a, op, modops.addmod)

    def sub_plain(self, a: Ct, op: PlainOperand) -> Ct:
        return self._plain_c0(a, op, modops.submod)

    def multiply_plain(self, a: Ct, op: PlainOperand) -> Ct:
        """Pointwise product with the cached NTT of the constant.  NTT-form
        cts multiply directly; coefficient-form cts bounce through the NTT
        (SEAL's Evaluator::multiply_plain does the same internally)."""
        dev = op.on(self.device)
        if a.ntt_form:
            return Ct(modops.mulmod_shoup(modops.to_i64(a.data), dev.mul_ntt,
                                          dev.mul_ntt_shoup, self.p), True)
        d = modops.to_i64(ntt.ntt(modops.to_u32(a.data), self.tables_q))
        d = modops.mulmod_shoup(d, dev.mul_ntt, dev.mul_ntt_shoup, self.p)
        return Ct(ntt.intt(modops.to_u32(d), self.tables_q), False)

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
