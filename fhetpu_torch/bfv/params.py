"""BFV/FV encryption parameters: ``fhetpu/bfv/params.py`` on this package's
JAX-free ``modops`` and ``ntt``.

A parameter set fixes:
* ring degree ``n`` (the reference's misnamed ``--cmod`` flag),
* plaintext modulus ``t`` (``--pmod``, default 1<<14),
* the RNS ciphertext modulus q = prod(q_primes) at 128-bit security,
* the BEHZ auxiliary base Bsk = b_primes + (m_sk,) used only for ct*ct
  multiplication,
* decomposition bit count ``dbc`` for relinearization keys,
* error distribution sigma (SEAL 2.3 default 3.19).

Everything derived (NTT tables, Barrett constants, CRT punctured products,
Delta = floor(q/t) in RNS) is computed once per parameter set and cached.
fhetpu's opt-in ``create_native`` chain is not carried over.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np

from ..core import modops, ntt
from ..core.primes import default_aux_modulus, default_coeff_modulus_128

DEFAULT_PLAIN_MODULUS = 1 << 14  # fhe_image.h:26
DEFAULT_POLY_DEGREE = 8192  # fhe_image.h:27 (named COEFF_MODULUS there)
DEFAULT_DBC = 30  # fhe_image.h:28
DEFAULT_SIGMA = 3.19
MAX_ERROR_MULT = 6.0  # truncate gaussian at 6 sigma


@dataclass(frozen=True)
class BfvParams:
    n: int
    t: int
    q_primes: tuple
    b_primes: tuple
    m_sk: int
    dbc: int = DEFAULT_DBC
    sigma: float = DEFAULT_SIGMA

    @staticmethod
    def create(
        n: int = DEFAULT_POLY_DEGREE,
        t: int = DEFAULT_PLAIN_MODULUS,
        dbc: int = DEFAULT_DBC,
        sigma: float = DEFAULT_SIGMA,
    ) -> "BfvParams":
        q = default_coeff_modulus_128(n)
        b, m_sk = default_aux_modulus(n)
        return BfvParams(n=n, t=t, q_primes=q, b_primes=b, m_sk=m_sk, dbc=dbc, sigma=sigma)

    # ----- basic derived quantities -------------------------------------

    @property
    def L(self) -> int:
        return len(self.q_primes)

    @property
    def q(self) -> int:
        return _prod(self.q_primes)

    @property
    def B(self) -> int:
        return _prod(self.b_primes)

    @property
    def bsk_primes(self) -> tuple:
        return tuple(self.b_primes) + (self.m_sk,)

    @property
    def delta(self) -> int:
        """Delta = floor(q/t), the plaintext scaling of FV."""
        return self.q // self.t

    @property
    def plain_upper_half_threshold(self) -> int:
        """Coefficients >= this are lifted by q - t (centered lift)."""
        return (self.t + 1) // 2

    def noise_budget_max(self) -> int:
        return self.q.bit_length() - self.t.bit_length() - 1

    # ----- cached table bundles -----------------------------------------

    @property
    def tables_q(self) -> ntt.NttTables:
        return ntt.get_tables(tuple(self.q_primes), self.n)

    @property
    def tables_bsk(self) -> ntt.NttTables:
        return ntt.get_tables(self.bsk_primes, self.n)

    @property
    def consts(self) -> "DerivedConsts":
        return _derived_consts(self)

    def describe(self) -> str:
        """print_parameters equivalent (fhe_image.h:493-506)."""
        return (
            "/ Encryption parameters:\n"
            f"| poly_modulus: 1x^{self.n} + 1\n"
            f"| coeff_modulus size: {self.q.bit_length()} bits "
            f"({self.L} primes)\n"
            f"| plain_modulus: {self.t}\n"
            f"\\ noise_standard_deviation: {self.sigma}\n"
        )


def _prod(xs) -> int:
    r = 1
    for x in xs:
        r *= int(x)
    return r


class DerivedConsts:
    """Host numpy constant arrays derived from a BfvParams."""

    def __init__(self, p: BfvParams):
        q_primes = [int(x) for x in p.q_primes]
        self.q = p.q
        self.t = p.t
        # Barrett triples for the q base, shaped [L, 1]
        self.qp, self.qmu, self.qshift = modops.barrett_params(q_primes)
        self.bskp, self.bskmu, self.bskshift = modops.barrett_params(
            [int(x) for x in p.bsk_primes]
        )
        # Delta = floor(q/t) mod each q prime  [L, 1]
        delta = p.delta
        self.delta_mod_q = np.array(
            [[delta % pi] for pi in q_primes], dtype=np.uint32
        )
        self.delta_mod_q_shoup = modops.shoup(
            self.delta_mod_q, self.qp.astype(np.uint64)
        )
        # q - t (for centered plaintext lift) mod each prime = (-t) mod pi
        self.neg_t_mod_q = np.array(
            [[(pi - p.t % pi) % pi] for pi in q_primes], dtype=np.uint32
        )
        # t mod each q prime (for noise computation / multiply scaling)
        self.t_mod_q = np.array([[p.t % pi] for pi in q_primes], dtype=np.uint32)
        # CRT: qhat_i = q / p_i;  qhat_inv_i = qhat_i^-1 mod p_i
        self.qhat = [p.q // pi for pi in q_primes]
        self.qhat_inv_mod_q = np.array(
            [[pow(qh % pi, pi - 2, pi)] for qh, pi in zip(self.qhat, q_primes)],
            dtype=np.uint32,
        )
        self.qhat_inv_mod_q_shoup = modops.shoup(
            self.qhat_inv_mod_q, self.qp.astype(np.uint64)
        )


@functools.lru_cache(maxsize=None)
def _derived_consts(p: BfvParams) -> DerivedConsts:
    return DerivedConsts(p)
