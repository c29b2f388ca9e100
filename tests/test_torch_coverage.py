"""The port covers fhetpu name by name.

Every public top-level function and class of every module under
``fhetpu/``, and every public method of such a class, has a counterpart
under ``fhetpu_torch/``: the same name in the mirrored module (the same
path, with the three Pallas modules mapped to their CUDA wrappers), or an
entry in ``MOVED`` (the port's name for it, elsewhere or renamed), or an
entry in ``NOT_PORTED`` (names tied to JAX or the TPU, and fhetpu's
four-step NTT and fast JPEG network, which lost to the port's kernels on
the H100; each with the reason).
Both packages are read with ``ast``; neither is imported.  Nested closures
are not checked.
"""

import ast
import pathlib

REPO = pathlib.Path(__file__).resolve().parents[1]

# fhetpu module -> its counterpart in fhetpu_torch, where the path differs
MIRROR = {
    "core/pallas_ntt.py": "core/ntt_kernel.py",
    "core/pallas_server.py": "core/server_kernel.py",
    "core/pallas_dct.py": "core/dct_kernel.py",
}

MOVED = {
    # a seeded image, or the file the caller names; fhetpu's reads a
    # reference image that is not in the repository
    "fhetpu/bench/benchmark.py:prep_image": "fhetpu_torch/bench/benchmark.py:source_image",
    # one subprocess runner for both sweeps
    "fhetpu/bench/decode_sweep.py:run": "fhetpu_torch/bench/benchmark.py:run",
    # the clients' send halves take an array (the card's host has no PIL)
    "fhetpu/cli/client_decode.py:run_send": "fhetpu_torch/cli/client_decode.py:send_array",
    "fhetpu/cli/client_jpeg.py:run_send": "fhetpu_torch/cli/client_jpeg.py:send_array",
    "fhetpu/cli/client_resize.py:run_send": "fhetpu_torch/cli/client_resize.py:send_array",
    # --device/--platform pick a torch device; there is no compile cache
    "fhetpu/cli/common.py:setup_platform": "fhetpu_torch/cli/common.py:resolve_device",
    # the Shoup product of the plain NTT passes
    "fhetpu/core/ntt.py:xp_mulmod_shoup": "fhetpu_torch/core/ntt.py:_mulmod_shoup",
    # the DCT-only kernel's wrapper
    "fhetpu/core/pallas_dct.py:dct8x8_pallas": "fhetpu_torch/core/dct_kernel.py:dct8x8_kernel",
    # the DCT-only kernel reads its rows of the fused kernels' tables
    "fhetpu/core/pallas_dct.py:pack_dct_constants":
        "fhetpu_torch/core/server_kernel.py:pack_server_constants",
    # make_ntt(forward=True) builds the forward NTT; forward=False is ntt_inverse
    "fhetpu/core/pallas_ntt.py:make_ntt": "fhetpu_torch/core/ntt_kernel.py:ntt_forward",
}

NOT_PORTED = {
    "fhetpu/bfv/evaluator.py:Ct.tree_flatten": "JAX pytree hook",
    "fhetpu/bfv/evaluator.py:Ct.tree_unflatten": "JAX pytree hook",
    "fhetpu/core/modops.py:mul32":
        "32x32->64 product in 16-bit halves for the TPU, which has no 64-bit multiply",
    "fhetpu/core/modops.py:mulhi32":
        "high word of a 32x32 product in 16-bit halves for the TPU; CUDA has __umulhi",
    "fhetpu/core/modops.py:reduce_once":
        "jnp.where conditional subtraction traced inside Pallas kernels",
    "fhetpu/core/pallas_ntt.py:default_rows_per_block": "TPU VMEM budget of a Pallas grid",
    "fhetpu/parallel/mesh.py:block_sharding": "a jax NamedSharding",
    "fhetpu/pipelines/resize.py:make_tile_fn": "jax.jit wrapper of resize_tile",
}
FOURSTEP = ("the four-step NTT as int8 digit-plane products: on the H100 a forward call at "
            "n = 4096, B = 64 took 3.0-4.9 ms (207 launches, host-bound) where the NTT "
            "kernel takes 20-33 us")
FAST_NETWORK = ("fhetpu's lazy, constant-folded JPEG network and its lazy-op layer: on the "
                "H100 its --quantize op took 326-332 ms at n = 4096, nb = 64 where the "
                "default one (DCT-only kernel) takes 124-126 ms, with the same bits")
NOT_PORTED.update({f"fhetpu/core/ntt4step.py:{name}": FOURSTEP
                   for name in ("FourStepTables", "get_fourstep", "ntt4")})
NOT_PORTED.update({f"fhetpu/core/lazy.py:{name}": FAST_NETWORK
                   for name in ("Lazy", "LazyOps", "LazyOps.reduce_to", "LazyOps.canon",
                                "LazyOps.add", "LazyOps.sub", "LazyOps.mul_shoup")})
NOT_PORTED["fhetpu/pipelines/jpeg_fast.py:server_ycc_dct_fast"] = FAST_NETWORK


def _defs(path: pathlib.Path, public_only: bool = True) -> set:
    """Top-level function and class names of a module, and 'Class.method'
    for the methods of its classes (public ones only, by default)."""
    def keep(name):
        return not (public_only and name.startswith("_"))

    funcs = (ast.FunctionDef, ast.AsyncFunctionDef)
    out = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, funcs + (ast.ClassDef,)) and keep(node.name):
            out.add(node.name)
            if isinstance(node, ast.ClassDef):
                out.update(f"{node.name}.{sub.name}" for sub in node.body
                           if isinstance(sub, funcs) and keep(sub.name))
    return out


def _modules():
    """(fhetpu module path, mirrored fhetpu_torch path), both relative to
    the repository."""
    for path in sorted((REPO / "fhetpu").rglob("*.py")):
        rel = path.relative_to(REPO / "fhetpu").as_posix()
        yield f"fhetpu/{rel}", f"fhetpu_torch/{MIRROR.get(rel, rel)}"


def _names_in(rel: str, public_only: bool = True) -> set:
    path = REPO / rel
    return _defs(path, public_only) if path.exists() else set()


def test_every_fhetpu_name_has_a_counterpart():
    missing = []
    for src, mirror in _modules():
        have = _names_in(mirror)
        for name in sorted(_names_in(src) - have):
            key = f"{src}:{name}"
            if key not in MOVED and key not in NOT_PORTED:
                missing.append(f"{key} (looked in {mirror})")
    assert not missing, "no counterpart in fhetpu_torch:\n" + "\n".join(missing)


def test_moved_and_not_ported_lists_are_current():
    mirrors = dict(_modules())
    stale = []
    for key in list(MOVED) + list(NOT_PORTED):
        src, name = key.split(":")
        if src not in mirrors or name not in _names_in(src):
            stale.append(f"{key}: no longer in fhetpu")
    for key, target in MOVED.items():
        rel, name = target.split(":")
        if name not in _names_in(rel, public_only=False):
            stale.append(f"{key} -> {target}: target not in fhetpu_torch")
    for key in NOT_PORTED:
        src, name = key.split(":")
        if src in mirrors and name in _names_in(mirrors[src]):
            stale.append(f"{key}: listed as not ported, but {mirrors[src]} has it")
    assert not stale, "\n".join(stale)
