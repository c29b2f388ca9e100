"""fhetpu_torch: the fhetpu BFV image pipelines in PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper (sm_90a).

The layout mirrors ``fhetpu/`` (core, bfv, pipelines, io, cli) so each
module's counterpart is easy to find.  ``fhetpu/`` (JAX) is the reference
this package is held against: the same parameters and input ciphertexts give
bit-identical uint32 RNS residues, and the ciphertext stream files of either
package are read by the other's clients and servers unchanged.

This package imports neither JAX nor anything of ``fhetpu``: the JAX-free
modules it needs (``core.primes``, ``bfv.encoder``, ``bfv.golden``,
``codec.jpeg``, ``io.images`` and ``native``, the host C++ NTT) are its own
copies, which the tests hold equal to the originals.
"""
