// Native host-side kernels for the trusted client path (encrypt/decrypt):
// fhetpu_torch's own copy of fhetpu/native/fastntt.cpp, built into
// fhetpu_torch/build/ by fhetpu_torch/native/__init__.py.
// batched negacyclic NTT / inverse NTT and pointwise modular multiply over
// RNS limbs.  TPU-native counterpart of the role SEAL's C++ polynomial core
// plays for the reference's client binaries (SURVEY.md C1): the accelerator
// side uses JAX/XLA, but client key/cipher operations stay on host, where
// NumPy's allocation overhead dominates -- this module replaces those inner
// loops (Harvey butterflies with Shoup multiplication, 64-bit scalar math,
// threaded over the ciphertext batch).
//
// Build: cc -O3 -march=native -shared -fPIC fastntt.cpp -o libfastntt.so
// ABI: plain C functions over uint32 arrays laid out [batch, L, n]
// (twiddle tables [L, n], per-limb scalars [L]).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// Barrett for p < 2^31 with mu = floor(2^64 / p): for x < 2^62,
// q = floor(x*mu / 2^64) >= floor(x/p) - 1, so one conditional subtract.
inline uint64_t barrett_mu(uint64_t p) {
    return (uint64_t)(((unsigned __int128)1 << 64) / p);
}

inline uint32_t mulmod_barrett(uint64_t a, uint64_t b, uint64_t p, uint64_t mu) {
    uint64_t x = a * b;  // < 2^62
    uint64_t q = (uint64_t)(((unsigned __int128)x * mu) >> 64);
    uint64_t r = x - q * p;
    if (r >= p) r -= p;
    return (uint32_t)r;
}

inline uint32_t mulmod_shoup(uint32_t x, uint32_t w, uint32_t w_sh, uint32_t p) {
    uint32_t q = (uint32_t)(((uint64_t)x * w_sh) >> 32);
    uint32_t r = x * w - q * p;  // mod 2^32; true value < 2p
    return r >= p ? r - p : r;
}

inline uint32_t addmod(uint32_t a, uint32_t b, uint32_t p) {
    uint32_t r = a + b;
    return r >= p ? r - p : r;
}

inline uint32_t submod(uint32_t a, uint32_t b, uint32_t p) {
    uint32_t r = a + p - b;
    return r >= p ? r - p : r;
}

// forward: Cooley-Tukey, natural in -> bit-reversed out (psi folded)
void ntt_poly(uint32_t* a, int n, const uint32_t* psi, const uint32_t* psi_sh,
              uint32_t p) {
    int t = n;
    for (int m = 1; m < n; m <<= 1) {
        t >>= 1;
        for (int i = 0; i < m; i++) {
            uint32_t S = psi[m + i];
            uint32_t Ssh = psi_sh[m + i];
            uint32_t* x = a + 2 * i * t;
            uint32_t* y = x + t;
            for (int j = 0; j < t; j++) {
                uint32_t U = x[j];
                uint32_t V = mulmod_shoup(y[j], S, Ssh, p);
                x[j] = addmod(U, V, p);
                y[j] = submod(U, V, p);
            }
        }
    }
}

// inverse: Gentleman-Sande, bit-reversed in -> natural out, then * n^-1
void intt_poly(uint32_t* a, int n, const uint32_t* ipsi, const uint32_t* ipsi_sh,
               uint32_t p, uint32_t ninv, uint32_t ninv_sh) {
    int t = 1;
    for (int m = n; m > 1; m >>= 1) {
        int h = m >> 1;
        int j1 = 0;
        for (int i = 0; i < h; i++) {
            uint32_t S = ipsi[h + i];
            uint32_t Ssh = ipsi_sh[h + i];
            uint32_t* x = a + j1;
            uint32_t* y = x + t;
            for (int j = 0; j < t; j++) {
                uint32_t U = x[j];
                uint32_t V = y[j];
                x[j] = addmod(U, V, p);
                y[j] = mulmod_shoup(submod(U, V, p), S, Ssh, p);
            }
            j1 += 2 * t;
        }
        t <<= 1;
    }
    for (int j = 0; j < n; j++) a[j] = mulmod_shoup(a[j], ninv, ninv_sh, p);
}

template <typename F>
void parallel_over(int64_t total, int threads, F&& fn) {
    if (threads <= 1 || total < 2) {
        fn(0, total);
        return;
    }
    std::vector<std::thread> ts;
    int64_t chunk = (total + threads - 1) / threads;
    for (int t = 0; t < threads; t++) {
        int64_t lo = t * chunk;
        int64_t hi = lo + chunk > total ? total : lo + chunk;
        if (lo >= hi) break;
        ts.emplace_back([=, &fn] { fn(lo, hi); });
    }
    for (auto& th : ts) th.join();
}

}  // namespace

extern "C" {

// data [batch, L, n] in-place; psi/psi_sh [L, n]; p [L]
void fastntt_forward(uint32_t* data, int64_t batch, int L, int n,
                     const uint32_t* psi, const uint32_t* psi_sh,
                     const uint32_t* p, int threads) {
    parallel_over(batch * L, threads, [&](int64_t lo, int64_t hi) {
        for (int64_t k = lo; k < hi; k++) {
            int limb = (int)(k % L);
            ntt_poly(data + k * n, n, psi + (int64_t)limb * n,
                     psi_sh + (int64_t)limb * n, p[limb]);
        }
    });
}

void fastntt_inverse(uint32_t* data, int64_t batch, int L, int n,
                     const uint32_t* ipsi, const uint32_t* ipsi_sh,
                     const uint32_t* p, const uint32_t* ninv,
                     const uint32_t* ninv_sh, int threads) {
    parallel_over(batch * L, threads, [&](int64_t lo, int64_t hi) {
        for (int64_t k = lo; k < hi; k++) {
            int limb = (int)(k % L);
            intt_poly(data + k * n, n, ipsi + (int64_t)limb * n,
                      ipsi_sh + (int64_t)limb * n, p[limb], ninv[limb],
                      ninv_sh[limb]);
        }
    });
}

// out = a * b mod p, all [batch, L, n]; b may broadcast with batch==1
void fastntt_pointwise_mulmod(const uint32_t* a, const uint32_t* b,
                              uint32_t* out, int64_t batch, int64_t b_batch,
                              int L, int n, const uint32_t* p, int threads) {
    parallel_over(batch * L, threads, [&](int64_t lo, int64_t hi) {
        for (int64_t k = lo; k < hi; k++) {
            int limb = (int)(k % L);
            int64_t bk = b_batch == 1 ? limb : (k % (b_batch * L));
            const uint32_t* av = a + k * n;
            const uint32_t* bv = b + bk * n;
            uint32_t* ov = out + k * n;
            uint64_t pp = p[limb];
            uint64_t mu = barrett_mu(pp);
            for (int j = 0; j < n; j++) {
                ov[j] = mulmod_barrett(av[j], bv[j], pp, mu);
            }
        }
    });
}

// Encrypt tail, fused (replaces three divide-heavy NumPy passes):
//   ct[b,c,i,:] += lift(e[b,c,:]) mod p_i            (gaussian noise)
//   ct[b,0,i,:] += delta_i * lift(m[b,:]) mod p_i    (Delta * message)
// ct [batch, 2, L, n] uint32 in-place; e [batch, 2, n] int32 with |e| < p;
// m [batch, n] int32 centered (already c-t for c >= (t+1)/2), |m| < p;
// delta, p [L] uint32.
void fastntt_encrypt_finish(uint32_t* ct, const int32_t* e, const int32_t* m,
                            int64_t batch, int L, int n,
                            const uint32_t* delta, const uint32_t* p,
                            int threads) {
    parallel_over(batch * 2 * L, threads, [&](int64_t lo, int64_t hi) {
        for (int64_t k = lo; k < hi; k++) {
            int limb = (int)(k % L);
            int c = (int)((k / L) % 2);
            int64_t b = k / (2 * L);
            uint32_t pp = p[limb];
            uint64_t mu = barrett_mu(pp);
            uint32_t* v = ct + k * n;
            const int32_t* ev = e + (b * 2 + c) * n;
            for (int j = 0; j < n; j++) {
                int32_t x = ev[j];
                uint32_t el = x < 0 ? (uint32_t)(x + (int64_t)pp) : (uint32_t)x;
                v[j] = addmod(v[j], el, pp);
            }
            if (c == 0) {
                const int32_t* mv = m + b * n;
                uint64_t d = delta[limb];
                for (int j = 0; j < n; j++) {
                    int32_t x = mv[j];
                    uint32_t ml =
                        x < 0 ? (uint32_t)(x + (int64_t)pp) : (uint32_t)x;
                    v[j] = addmod(v[j], mulmod_barrett(ml, d, pp, mu), pp);
                }
            }
        }
    });
}

// dst[b,l,:] += src[b,l,:] * w[l] mod p_l (Shoup scalar per limb), one
// pass -- the decrypt fast path's "+ c0 * qhat_inv" fold (the NumPy
// where-based version was ~2 ms/ct of pure memory traffic at n=16384).
void fastntt_scalar_muladd(uint32_t* dst, const uint32_t* src, int64_t batch,
                           int L, int n, const uint32_t* w,
                           const uint32_t* w_sh, const uint32_t* p,
                           int threads) {
    parallel_over(batch * L, threads, [&](int64_t lo, int64_t hi) {
        for (int64_t k = lo; k < hi; k++) {
            int limb = (int)(k % L);
            uint32_t pp = p[limb], ww = w[limb], wsh = w_sh[limb];
            uint32_t* d = dst + k * n;
            const uint32_t* s = src + k * n;
            for (int j = 0; j < n; j++) {
                d[j] = addmod(d[j], mulmod_shoup(s[j], ww, wsh, pp), pp);
            }
        }
    });
}

// CRT-decode tail of BFV decryption, fused (replaces ~10 allocation-heavy
// NumPy passes over [B, L, n] temporaries):
//   v(j)  = sum_l (z[b,l,j] * t) / p_l          (f64, exact-direction)
//   m(j)  = floor(v + 0.5) mod t  ->  out_m (int64 [batch, n])
//   risky = |frac(v) - 0.5| < 1e-6 ->  out_risky (uint8 [batch, n]);
// the caller re-resolves risky coefficients with exact big-int CRT.
// recip[l] = 1.0 / p_l precomputed (2-ulp relative error on v, far inside
// the 1e-6 fallback window).  Parallel over the batch.
void fastntt_crt_decode(const uint32_t* z, int64_t batch, int L, int n,
                        uint64_t t, const double* recip, int64_t* out_m,
                        uint8_t* out_risky, int threads) {
    parallel_over(batch, threads, [&](int64_t lo, int64_t hi) {
        std::vector<double> acc((size_t)n);
        for (int64_t b = lo; b < hi; b++) {
            const uint32_t* zb = z + b * (int64_t)L * n;
            for (int j = 0; j < n; j++) acc[j] = 0.0;
            for (int l = 0; l < L; l++) {
                const uint32_t* zl = zb + (int64_t)l * n;
                double r = recip[l];
                for (int j = 0; j < n; j++) {
                    acc[j] += (double)((uint64_t)zl[j] * t) * r;
                }
            }
            int64_t* mb = out_m + b * (int64_t)n;
            uint8_t* rb = out_risky + b * (int64_t)n;
            for (int j = 0; j < n; j++) {
                double v = acc[j];
                double fl = std::floor(v);
                double frac = v - fl;
                rb[j] = (uint8_t)(std::fabs(frac - 0.5) < 1e-6);
                int64_t m = (int64_t)std::floor(v + 0.5);
                int64_t r = m % (int64_t)t;
                mb[j] = r < 0 ? r + (int64_t)t : r;
            }
        }
    });
}

// out[b, i, :] = NTT_i(lift_i(u[b, :])): signed-int8 ternary/small input
// lifted into each RNS limb and transformed, one pass, no int64 temps.
void fastntt_lift_forward_i8(const int8_t* u, uint32_t* out, int64_t batch,
                             int L, int n, const uint32_t* psi,
                             const uint32_t* psi_sh, const uint32_t* p,
                             int threads) {
    parallel_over(batch * L, threads, [&](int64_t lo, int64_t hi) {
        for (int64_t k = lo; k < hi; k++) {
            int limb = (int)(k % L);
            int64_t b = k / L;
            uint32_t pp = p[limb];
            uint32_t* v = out + k * n;
            const int8_t* uv = u + b * n;
            for (int j = 0; j < n; j++) {
                int32_t x = uv[j];
                v[j] = x < 0 ? (uint32_t)(x + (int64_t)pp) : (uint32_t)x;
            }
            ntt_poly(v, n, psi + (int64_t)limb * n, psi_sh + (int64_t)limb * n,
                     pp);
        }
    });
}

}  // extern "C"
