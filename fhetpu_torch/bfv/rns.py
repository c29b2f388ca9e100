"""BEHZ RNS machinery for BFV ciphertext-by-ciphertext multiplication.

Port of ``fhetpu/bfv/rns.py``: the Bajard-Eynard-Hasan-Zucca full-RNS FV
multiply (the role of SEAL's Evaluator::multiply/square):

  1. exact base extension q -> Bsk = B + {m_sk} with the m~ = 2^16
     Montgomery correction,
  2. negacyclic tensor product in the NTT domain over both bases; sizes
     compose as k1 + k2 - 1,
  3. approximate scale-and-floor by t/q in Bsk (fast floor; the error of at
     most L units is absorbed by the noise),
  4. exact Shenoy-Kumaresan conversion Bsk -> q through m_sk.

On CUDA tensors step 1 runs as one kernel on the operand's uint32 residues,
step 2 as another on the forward NTTs' uint32 outputs, and steps 3 and 4 as
a third on the inverse NTTs' uint32 outputs (``core/behz_kernel.py``); the
torch steps below serve CPU tensors and are the kernels' oracle.

``BehzConsts`` is fhetpu's table set, built the same way from Python
big-ints (tests hold the two equal table by table).  The steps are plain
functions of int64 tensors: every residue is below 2^30, so ``a * b % p``
is exact and gives the bits of fhetpu's Barrett products, which the BEHZ
steps also feed operands reduced by another base's primes (values below
2^30).  A sum of canonical residues is reduced once at its end; fhetpu
reduces after every add, which gives the same canonical value.  The
arithmetic modulo m~ = 2^16 masks once at the end, where fhetpu's uint32
wraps and masks after every step: both are exact modulo 2^16.  Every NTT
goes through ``core.ntt`` (the CUDA kernels on a card) on ``tables_q`` and
``tables_bsk``.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..core import behz_kernel, modops, ntt
from ..trace import span
from .params import BfvParams, _prod


class BehzConsts:
    """Precomputed constant tables for one parameter set (host NumPy)."""

    def __init__(self, par: BfvParams):
        q_primes = [int(x) for x in par.q_primes]
        bsk = [int(x) for x in par.bsk_primes]
        b_primes = bsk[:-1]
        m_sk = bsk[-1]
        m_tilde = 1 << 16
        L, K = len(q_primes), len(bsk)
        q = par.q
        B = _prod(b_primes)

        self.L, self.K = L, K
        self.m_tilde = m_tilde

        c = par.consts
        self.qp, self.qmu, self.qshift = c.qp, c.qmu, c.qshift
        self.bskp, self.bskmu, self.bskshift = c.bskp, c.bskmu, c.bskshift

        # --- base extension q -> Bsk with m~ correction ---
        # x'_i = x_i * m~ mod p_i
        self.m_tilde_mod_q = np.array(
            [[m_tilde % p] for p in q_primes], dtype=np.uint32
        )
        # z_i = x'_i * qhat_i^-1 mod p_i
        self.qhat_inv_mod_q = c.qhat_inv_mod_q  # [L,1]
        # (q/p_i) mod b_j for b_j in Bsk:  [L, K]
        self.q_over_pi_mod_bsk = np.array(
            [[(q // p) % bj for bj in bsk] for p in q_primes], dtype=np.uint32
        )
        # (q/p_i) mod m~ (m~ = 2^16: just low bits)
        self.q_over_pi_mod_mtilde = np.array(
            [(q // p) % m_tilde for p in q_primes], dtype=np.uint32
        )
        # -q^-1 mod m~
        self.neg_q_inv_mod_mtilde = (-pow(q % m_tilde, _phi_pow2_inv(m_tilde), m_tilde)) % m_tilde
        # q mod b_j, m~^-1 mod b_j
        self.q_mod_bsk = np.array([[q % bj] for bj in bsk], dtype=np.uint32)
        self.m_tilde_inv_mod_bsk = np.array(
            [[pow(m_tilde % bj, bj - 2, bj)] for bj in bsk], dtype=np.uint32
        )

        # --- scale by t and fast-floor by q, in Bsk ---
        self.t_mod_q = c.t_mod_q  # [L,1]
        self.t_mod_bsk = np.array([[par.t % bj] for bj in bsk], dtype=np.uint32)
        self.q_inv_mod_bsk = np.array(
            [[pow(q % bj, bj - 2, bj)] for bj in bsk], dtype=np.uint32
        )

        # --- Shenoy-Kumaresan Bsk -> q ---
        # Bhat_j = B / b_j ; Bhat_inv_j mod b_j   (over B primes only)
        self.bhat_inv_mod_b = np.array(
            [[pow((B // bj) % bj, bj - 2, bj)] for bj in b_primes], dtype=np.uint32
        )
        self.b_over_bj_mod_msk = np.array(
            [(B // bj) % m_sk for bj in b_primes], dtype=np.uint32
        )
        self.b_inv_mod_msk = pow(B % m_sk, m_sk - 2, m_sk)
        self.b_over_bj_mod_q = np.array(
            [[(B // bj) % p for p in q_primes] for bj in b_primes], dtype=np.uint32
        )  # [K-1, L]
        self.b_mod_q = np.array([[B % p] for p in q_primes], dtype=np.uint32)
        self.m_sk = m_sk
        (self.mskp,), (self.mskmu,), (self.mskshift,) = (
            np.array([m_sk], np.uint32),
            np.array([modops.barrett_params([m_sk])[1][0, 0]], np.uint32),
            np.array([modops.barrett_params([m_sk])[2][0, 0]], np.uint32),
        )


def _phi_pow2_inv(m: int) -> int:
    """Exponent for inverse mod power of two: phi(2^k) - 1 = 2^(k-1) - 1."""
    return (m >> 1) - 1


@functools.lru_cache(maxsize=None)
def get_behz(par: BfvParams) -> BehzConsts:
    return BehzConsts(par)


def _ntt(x: torch.Tensor, tables) -> torch.Tensor:
    """Forward NTT of int64 residues [..., L, n] -> int64 (kernel on CUDA)."""
    return modops.to_i64(ntt.ntt(modops.to_u32(x).contiguous(), tables))


def _intt(x: torch.Tensor, tables) -> torch.Tensor:
    """Inverse NTT of int64 or uint32 residues [..., L, n] -> uint32 (kernel
    on CUDA); a contiguous uint32 input goes in as it is."""
    return ntt.intt(modops.to_u32(x).contiguous(), tables)


class RnsTool:
    """The BEHZ steps on one device; holds BehzConsts as int64 tensors there."""

    def __init__(self, par: BfvParams, device):
        self.par = par
        self.device = torch.device(device)
        bc = get_behz(par)
        self.bc = bc
        self.tables_q = par.tables_q
        self.tables_bsk = par.tables_bsk

        def up(a):
            return torch.from_numpy(np.asarray(a, dtype=np.int64)).to(self.device)

        L, K = bc.L, bc.K
        self.qp, self.bp = up(bc.qp), up(bc.bskp)  # [L,1], [K,1]
        self.m_tilde_mod_q = up(bc.m_tilde_mod_q)
        self.qhat_inv_mod_q = up(bc.qhat_inv_mod_q)
        self.q_over_pi_mod_bsk = up(bc.q_over_pi_mod_bsk).reshape(L, K, 1)
        self.q_over_pi_mod_mtilde = up(bc.q_over_pi_mod_mtilde).reshape(L, 1)
        self.q_mod_bsk = up(bc.q_mod_bsk)
        self.m_tilde_inv_mod_bsk = up(bc.m_tilde_inv_mod_bsk)
        self.t_mod_q = up(bc.t_mod_q)
        self.t_mod_bsk = up(bc.t_mod_bsk)
        self.q_inv_mod_bsk = up(bc.q_inv_mod_bsk)
        self.bhat_inv_mod_b = up(bc.bhat_inv_mod_b)  # [K-1,1]
        self.b_over_bj_mod_msk = up(bc.b_over_bj_mod_msk).reshape(K - 1, 1)
        self.b_over_bj_mod_q = up(bc.b_over_bj_mod_q).reshape(K - 1, L, 1)
        self.b_mod_q = up(bc.b_mod_q)

    @functools.cached_property
    def floor_convert_table(self) -> behz_kernel.DeviceBehzTable:
        """The floor-convert kernel's table, built at the first multiply on a
        CUDA device; raises where the kernel cannot take the base."""
        return behz_kernel.DeviceBehzTable.build(self.bc, self.device, "floor_convert")

    @functools.cached_property
    def tensor_table(self) -> behz_kernel.DeviceBehzTable:
        """The tensor kernel's table, built at the first multiply on a CUDA
        device; raises where the kernel cannot take the base."""
        return behz_kernel.DeviceBehzTable.build(self.bc, self.device, "tensor")

    @functools.cached_property
    def extend_table(self) -> behz_kernel.DeviceBehzTable:
        """The extension kernel's table, built at the first multiply on a
        CUDA device; raises where the kernel cannot take the base."""
        return behz_kernel.DeviceBehzTable.build(self.bc, self.device, "extend")

    def _sum_q_to_bsk(self, z: torch.Tensor) -> torch.Tensor:
        """sum_i z_i * (q/p_i mod b_j) mod b_j: [..., L, n] -> [..., K, n]."""
        acc = None
        for i in range(self.bc.L):
            term = modops.mulmod(z[..., i:i + 1, :], self.q_over_pi_mod_bsk[i], self.bp)
            acc = term if acc is None else acc + term
        return acc % self.bp

    # -- step 1: exact conversion of [..., L, n] -> [..., K, n] ------------

    def extend_q_to_bsk(self, x: torch.Tensor) -> torch.Tensor:
        bc = self.bc
        m_tilde = bc.m_tilde
        # x' = x * m~ mod q ; z = x' * qhat_inv mod q
        xp = modops.mulmod(x, self.m_tilde_mod_q, self.qp)
        z = modops.mulmod(xp, self.qhat_inv_mod_q, self.qp)  # [..., L, n]
        y = self._sum_q_to_bsk(z)  # [..., K, n]
        # y_mtilde = sum_i z_i * (q/p_i mod m~)  mod m~
        ym = ((z & (m_tilde - 1)) * self.q_over_pi_mod_mtilde).sum(dim=-2) & (m_tilde - 1)
        # r = -y_mtilde * q^-1 mod m~, centred: r >= m~/2 stands for r - m~
        r = (ym * bc.neg_q_inv_mod_mtilde) & (m_tilde - 1)
        r = torch.where(r >= m_tilde // 2, r - m_tilde, r)
        # (y + q * r) * m~^-1 mod b_j; % takes the sign of the prime
        qr = r[..., None, :] * self.q_mod_bsk % self.bp
        return modops.mulmod(y + qr, self.m_tilde_inv_mod_bsk, self.bp)

    # -- step 3: floor(t*x/q) in Bsk --------------------------------------

    def scale_floor_to_bsk(self, tx_q: torch.Tensor, tx_bsk: torch.Tensor) -> torch.Tensor:
        """Given t*x in base q ([..., L, n]) and in Bsk ([..., K, n]),
        return approx round(t*x/q) in Bsk (error <= L absorbed in noise)."""
        z = modops.mulmod(tx_q, self.qhat_inv_mod_q, self.qp)
        f = self._sum_q_to_bsk(z)
        return (tx_bsk - f) * self.q_inv_mod_bsk % self.bp

    # -- step 4: exact Bsk -> q (Shenoy-Kumaresan) -------------------------

    def convert_bsk_to_q(self, x_bsk: torch.Tensor) -> torch.Tensor:
        with span("bfv.rns.convert"):
            bc = self.bc
            nb = bc.K - 1  # number of B primes
            m_sk = bc.m_sk
            z = modops.mulmod(x_bsk[..., :nb, :], self.bhat_inv_mod_b, self.bp[:nb])
            # alpha = (sum_j z_j * (B/b_j) - x_msk) * B^-1 mod m_sk, centred
            acc = modops.mulmod(z, self.b_over_bj_mod_msk, m_sk).sum(dim=-2)
            alpha = (acc - x_bsk[..., nb, :]) % m_sk * bc.b_inv_mod_msk % m_sk
            alpha = torch.where(alpha >= m_sk // 2, alpha - m_sk, alpha)
            # x_i = sum_j z_j*(B/b_j) - alpha_c*B  mod p_i
            xq = None
            for j in range(nb):
                term = modops.mulmod(z[..., j:j + 1, :], self.b_over_bj_mod_q[j], self.qp)
                xq = term if xq is None else xq + term
            return (xq - alpha[..., None, :] * self.b_mod_q) % self.qp


def tensor_product(a_q, a_b, b_q, b_b, tool: RnsTool) -> tuple:
    """Step 2 in torch int64: the NTT-domain tensor product of operands
    ``[..., k1, L, n]`` and ``[..., k1, K, n]`` (``a_q``, ``a_b``) and ``b``
    likewise with k2 components, canonical residues, batch axes
    broadcasting -> int64 ``[..., k1 + k2 - 1, L, n]`` and ``[..., K, n]``.
    The CPU path of ``multiply``, and the oracle of the tensor kernel."""
    k1, k2 = a_q.shape[-3], b_q.shape[-3]
    out_q, out_b = [], []
    for r in range(k1 + k2 - 1):
        acc_q = acc_b = None
        for i in range(max(0, r - k2 + 1), min(k1, r + 1)):
            j = r - i
            tq = modops.mulmod(a_q[..., i, :, :], b_q[..., j, :, :], tool.qp)
            tb = modops.mulmod(a_b[..., i, :, :], b_b[..., j, :, :], tool.bp)
            acc_q = tq if acc_q is None else acc_q + tq
            acc_b = tb if acc_b is None else acc_b + tb
        out_q.append(acc_q % tool.qp)
        out_b.append(acc_b % tool.bp)
    return torch.stack(out_q, dim=-3), torch.stack(out_b, dim=-3)


def multiply(ct1: torch.Tensor, ct2: torch.Tensor, tool: RnsTool) -> torch.Tensor:
    """Full BEHZ multiply of coefficient-form ciphertexts (uint32 or int64)
    [..., k1, L, n] x [..., k2, L, n] -> int64 [..., k1+k2-1, L, n]; the
    batch axes broadcast.  Counts its calls and the (component,
    coefficient) positions of its operands and of its product."""
    k1, k2 = ct1.shape[-3], ct2.shape[-3]
    n = ct1.shape[-1]
    multiply.calls += 1
    multiply.positions_in += (ct1.numel() + (0 if ct2 is ct1 else ct2.numel())) // ct1.shape[-2]
    multiply.positions_out += (math.prod(torch.broadcast_shapes(ct1.shape[:-3], ct2.shape[:-3]))
                               * (k1 + k2 - 1) * n)

    # 1. extend to Bsk, NTT in both bases (uint32 on CUDA, int64 on the CPU)
    def prep(ct):
        if ct.device.type == "cuda":
            x = modops.to_u32(ct).contiguous()
            x_b = behz_kernel.behz_extend(x, tool.extend_table)
            return ntt.ntt(x, tool.tables_q), ntt.ntt(x_b, tool.tables_bsk)
        x = modops.to_i64(ct)
        return _ntt(x, tool.tables_q), _ntt(tool.extend_q_to_bsk(x), tool.tables_bsk)

    with span("bfv.rns.extend"):
        a_q, a_b = prep(ct1)
        b_q, b_b = (a_q, a_b) if ct2 is ct1 else prep(ct2)
    # 2. tensor product (sizes k1+k2-1)
    with span("bfv.rns.tensor"):
        if a_q.device.type == "cuda":
            out_q, out_b = behz_kernel.behz_tensor(a_q, a_b, b_q, b_b, tool.tensor_table)
        else:
            out_q, out_b = tensor_product(a_q, a_b, b_q, b_b, tool)
        del a_q, a_b, b_q, b_b
        prod_q = _intt(out_q, tool.tables_q)
        prod_b = _intt(out_b, tool.tables_bsk)
        del out_q, out_b
    # 3. multiply by t, fast-floor by q (in Bsk); on CUDA 4. too
    with span("bfv.rns.scale_floor"):
        if prod_q.device.type == "cuda":
            return behz_kernel.behz_floor_convert(prod_q, prod_b, tool.floor_convert_table)
        prod_q, prod_b = modops.to_i64(prod_q), modops.to_i64(prod_b)
        tx_q = modops.mulmod(prod_q, tool.t_mod_q, tool.qp)
        tx_b = modops.mulmod(prod_b, tool.t_mod_bsk, tool.bp)
        scaled_bsk = tool.scale_floor_to_bsk(tx_q, tx_b)
    # 4. back to q
    return tool.convert_bsk_to_q(scaled_bsk)


multiply.calls = 0  # calls
multiply.positions_in = 0  # the operands' positions as passed, a squared one once
multiply.positions_out = 0  # the broadcast batch x (k1 + k2 - 1) x n a call
