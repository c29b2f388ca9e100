"""The port takes fhetpu's arguments: signatures and CLI flags.

Every public function and method that ``tests/test_torch_coverage.py``
pairs up (the same name in the mirrored module, or a ``MOVED`` target), and
each class's ``__init__``, has fhetpu's parameter names, in fhetpu's order,
with fhetpu's defaults, but for the edits listed in ``SIGNATURE_DIFFS``
with their reason.  Every ``add_argument`` of ``fhetpu/cli/*.py`` appears in
the same module of ``fhetpu_torch/cli/`` with the same option strings and
the same ``action``, ``type`` and default where fhetpu's are literal; the
port adds only the flags in ``EXTRA_FLAGS``.  Both packages are read with
``ast``; neither is imported.
"""

import ast
import pathlib

from test_torch_coverage import MOVED, NOT_PORTED, REPO, _modules

# why the port's signature differs, by kind
DEVICE = ("a torch device to run on (or fhetpu's platform name, renamed): fhetpu's "
          "arrays go to JAX's default device")
JAX_SWITCHES = ("switches between fhetpu's JAX and Pallas implementations and their "
                "TPU tiling; the port has one implementation per op")
PER_UNIT = ("OpTimer's per_unit and its context-manager form, which no CLI of either "
            "package uses; every span names its units")
BARRETT = ("the TPU's Barrett constants; the port reduces int64 products with an exact %, "
           "which gives the same bits (p < 2^30)")
ARRAY_NAMESPACE = "fhetpu's helper takes numpy or jax.numpy as xp; the port's is torch only"
IN_PROCESS = "argv, so that the tests and chip_smoke.py call the entry point in process"
ARRAY_IN = ("the client's send half takes the image as an array: the card's host has no "
            "PIL, and chip_smoke.py sends seeded images")
ORIG_ARRAY = ("the original image as an array, so the RMS is taken without PIL (the "
              "sweeps pass it); None reads args.file as fhetpu does")
SEEDED_IMAGE = ("a seeded image, or the file named: fhetpu's reads a reference image "
                "that is not in the repository")
TIMEOUT = "a stage timeout, so that a hung stage is killed and logged as 124 instead of stalling"
TORCH_SHARDS = ("the port's sharding is a block range on a torch device, not a JAX "
                "sharding: it takes the block count and that range")
TORCH_REPLICATE = ("fhetpu's returns a JAX NamedSharding to place arrays with; the port "
                   "places the tensor itself")
RNS_TOOL = ("the port's BEHZ ops take Ct objects and the per-device RnsTool, which "
            "carries the parameters and its tables on the ciphertexts' device")
NTT_WRAPPER = ("fhetpu's factory returns a jitted transform of the tables; the port's "
               "wrapper transforms x with tables already on its device")
NO_FAST_NETWORK = ("use_fast selects fhetpu's lazy, constant-folded network, which the port "
                   "does not keep: it lost to the default op on the H100 with the same bits")
MEASURE = ("chains a torch callable on the device between CUDA events instead of a "
           "jitted loop of k; target_seconds 0.0 reads TARGET_SECONDS at call time")

# fhetpu name -> (the edits that turn fhetpu's parameters into the port's, why):
# "drop" removes fhetpu's, "rename" maps fhetpu's name to the port's,
# "default" gives the port's default ("" for none), "add" the port's new
# parameters with their defaults ("" for none).  Every other parameter keeps
# its name, order and default.
SIGNATURE_DIFFS = {
    "fhetpu/bench/benchmark.py:call_pipeline": (
        {"rename": {"platform": "device"}, "add": {"img": "", "img_tag": "None"}},
        DEVICE + "; " + SEEDED_IMAGE),
    "fhetpu/bench/benchmark.py:main": ({"add": {"argv": "None"}}, IN_PROCESS),
    "fhetpu/bench/benchmark.py:prep_image": (
        {"drop": ["workdir"], "add": {"path": "''"}}, SEEDED_IMAGE),
    "fhetpu/bench/decode_sweep.py:main": ({"add": {"argv": "None"}}, IN_PROCESS),
    "fhetpu/bench/decode_sweep.py:run": ({"add": {"timeout": "None"}}, TIMEOUT),
    "fhetpu/bench/noise_validation.py:measure_harmonics": ({"add": {"device": ""}}, DEVICE),
    "fhetpu/bench/noise_validation.py:measure_jpeg": ({"add": {"device": ""}}, DEVICE),
    "fhetpu/bench/noise_validation.py:measure_resize": ({"add": {"device": ""}}, DEVICE),
    "fhetpu/bench/noise_validation.py:run_point": ({"add": {"device": "'cuda'"}}, DEVICE),
    "fhetpu/bench/timing.py:measure": (
        {"rename": {"jloop": "fn"}, "default": {"target_seconds": "0.0"},
         "add": {"device": ""}}, MEASURE + "; " + DEVICE),
    "fhetpu/bfv/evaluator.py:DeviceRelinKeys.stacked": ({"add": {"device": ""}}, DEVICE),
    "fhetpu/bfv/evaluator.py:Evaluator.__init__": ({"add": {"device": "'cuda'"}}, DEVICE),
    "fhetpu/bfv/rns.py:RnsTool.__init__": ({"add": {"device": ""}}, DEVICE),
    "fhetpu/bfv/rns.py:multiply": (
        {"rename": {"ct1_data": "ct1", "ct2_data": "ct2"}, "drop": ["par"],
         "default": {"tool": ""}}, RNS_TOOL),
    "fhetpu/cli/client_decode.py:run_send": ({"add": {"img": ""}}, ARRAY_IN),
    "fhetpu/cli/client_jpeg.py:run_send": ({"add": {"img": ""}}, ARRAY_IN),
    "fhetpu/cli/client_resize.py:run_send": ({"add": {"img": ""}}, ARRAY_IN),
    "fhetpu/cli/client_jpeg.py:run_recieve": ({"add": {"orig": "None"}}, ORIG_ARRAY),
    "fhetpu/cli/common.py:OpTimer.__init__": ({"drop": ["per_unit"]}, PER_UNIT),
    "fhetpu/cli/common.py:OpTimer.span": ({"default": {"units": ""}}, PER_UNIT),
    "fhetpu/core/modops.py:mulmod": ({"drop": ["mu", "shift"]}, BARRETT),
    "fhetpu/core/ntt.py:xp_mulmod_shoup": ({"drop": ["xp"]}, ARRAY_NAMESPACE),
    "fhetpu/core/pallas_dct.py:dct8x8_pallas": ({"drop": ["interpret"]}, JAX_SWITCHES),
    "fhetpu/core/pallas_ntt.py:make_ntt": (
        {"drop": ["params_or_tables", "forward", "rows_per_block", "interpret"],
         "add": {"x": "", "dt": ""}}, NTT_WRAPPER + "; " + JAX_SWITCHES),
    "fhetpu/core/pallas_server.py:server_ycc_dct_fused": (
        {"drop": ["interpret", "chunk"]}, JAX_SWITCHES),
    "fhetpu/parallel/distributed.py:distribute_ciphertexts": (
        {"rename": {"sharding": "shard"}}, TORCH_SHARDS),
    "fhetpu/parallel/distributed.py:global_block_sharding": (
        {"drop": ["mesh_axes"], "add": {"nb": ""}}, TORCH_SHARDS),
    "fhetpu/parallel/distributed.py:init_distributed": ({"add": {"device": "None"}}, DEVICE),
    "fhetpu/parallel/mesh.py:replicated": (
        {"add": {"x": "", "axis": "None"}}, TORCH_REPLICATE),
    "fhetpu/pipelines/jpeg_encode.py:make_server": (
        {"drop": ["use_pallas", "use_fused"]}, JAX_SWITCHES),
    "fhetpu/pipelines/jpeg_encode.py:server_compute_fn": (
        {"drop": ["use_pallas", "pallas_interpret", "use_fused", "fused_chunk", "use_fast"]},
        JAX_SWITCHES + "; " + NO_FAST_NETWORK),
}

# flags the port's CLIs have and fhetpu's do not, by module
EXTRA_FLAGS = {
    "cli/common.py": {
        "--device": "the torch device to run on (cuda by default); fhetpu's --platform "
                    "is accepted as well",
    },
}

FUNCS = (ast.FunctionDef, ast.AsyncFunctionDef)


def _params(fn) -> list:
    """[(name, default source or "")] in order; "*" marks where keyword-only
    parameters start, "*name" and "**name" the variadic ones."""
    a = fn.args
    pos = a.posonlyargs + a.args
    defaults = [""] * (len(pos) - len(a.defaults)) + [ast.unparse(d) for d in a.defaults]
    out = [(p.arg, d) for p, d in zip(pos, defaults)]
    if a.vararg:
        out.append(("*" + a.vararg.arg, ""))
    elif a.kwonlyargs:
        out.append(("*", ""))
    out += [(p.arg, "" if d is None else ast.unparse(d)) for p, d in zip(a.kwonlyargs,
                                                                      a.kw_defaults)]
    if a.kwarg:
        out.append(("**" + a.kwarg.arg, ""))
    return out


def _signatures(rel: str) -> dict:
    """{'f' or 'Class.method': parameters} of a module's top level."""
    path = REPO / rel
    if not path.exists():
        return {}
    out = {}
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, FUNCS):
            out[node.name] = _params(node)
        elif isinstance(node, ast.ClassDef):
            out.update((f"{node.name}.{sub.name}", _params(sub)) for sub in node.body
                       if isinstance(sub, FUNCS))
    return out


def _public(name: str) -> bool:
    return all(part == "__init__" or not part.startswith("_") for part in name.split("."))


def _pairs():
    """(fhetpu key, fhetpu's parameters, the port's) for every function and
    method the name check pairs up."""
    for src, mirror in _modules():
        ours = _signatures(mirror)
        for name, params in sorted(_signatures(src).items()):
            key = f"{src}:{name}"
            if not _public(name) or key in NOT_PORTED:
                continue
            if key in MOVED:
                rel, moved = MOVED[key].split(":")
                yield key, params, _signatures(rel).get(moved)
            elif name in ours:
                yield key, params, ours[name]


def _fmt(params) -> str:
    return ", ".join(f"{n}={d}" if d else n for n, d in params)


def _edited(params: list, edits: dict) -> list:
    """fhetpu's parameters with the listed drops, renames and defaults."""
    rename, default = edits.get("rename", {}), edits.get("default", {})
    out = []
    for name, d in params:
        if name in edits.get("drop", ()):
            continue
        name = rename.get(name, name)
        out.append((name, default.get(name, d)))
    return out


def test_signatures_match_fhetpu_or_are_listed():
    bad = []
    for key, ref, ours in _pairs():
        edits, _why = SIGNATURE_DIFFS.get(key, ({}, ""))
        added = edits.get("add", {})
        kept = [p for p in ours if p[0] not in added]
        new = sorted(p for p in ours if p[0] in added)
        if _edited(ref, edits) != kept or new != sorted(added.items()):
            bad.append(f"{key}\n  fhetpu: ({_fmt(ref)})\n  port:   ({_fmt(ours)})"
                       + (f"\n  listed edits: {edits}" if edits else ""))
    assert not bad, "signatures differ from fhetpu's beyond SIGNATURE_DIFFS:\n" + "\n".join(bad)


def test_signature_differences_are_current():
    """Each listed difference still pairs two functions that differ."""
    pairs = {key: (ref, ours) for key, ref, ours in _pairs()}
    stale = [key for key in SIGNATURE_DIFFS if key not in pairs or pairs[key][0] == pairs[key][1]]
    assert not stale, "SIGNATURE_DIFFS lists no difference for:\n" + "\n".join(stale)
    assert all(why for _edits, why in SIGNATURE_DIFFS.values())


def _flags(rel: str) -> dict:
    """{option strings: {action/type/default: value}} of every add_argument
    in a module; a value fhetpu computes (not a literal or a name) is
    recorded as None and not compared."""
    path = REPO / rel
    out = {}
    for node in ast.walk(ast.parse(path.read_text())):
        if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "add_argument"):
            continue
        names = tuple(ast.literal_eval(a) for a in node.args)
        spec = {}
        for kw in node.keywords:
            if kw.arg in ("action", "type", "default"):
                if isinstance(kw.value, ast.Name):
                    spec[kw.arg] = kw.value.id
                else:
                    try:
                        spec[kw.arg] = repr(ast.literal_eval(kw.value))
                    except ValueError:
                        spec[kw.arg] = None
        out[names] = spec
    return out


def _cli_modules():
    for path in sorted((REPO / "fhetpu" / "cli").glob("*.py")):
        rel = path.relative_to(REPO / "fhetpu").as_posix()
        yield rel, _flags(f"fhetpu/{rel}"), _flags(f"fhetpu_torch/{rel}")


def test_cli_flags_match_fhetpu():
    bad = []
    for rel, ref, ours in _cli_modules():
        for names, spec in ref.items():
            if names not in ours:
                bad.append(f"{rel}: {'/'.join(names)} has no add_argument in fhetpu_torch")
                continue
            got = ours[names]
            fixed = {k for k, v in spec.items() if v is None}
            want = {k: v for k, v in spec.items() if k not in fixed}
            have = {k: v for k, v in got.items() if k not in fixed}
            if want != have:
                bad.append(f"{rel}: {'/'.join(names)}: fhetpu {want}, port {have}")
    assert not bad, "CLI flags differ from fhetpu's:\n" + "\n".join(bad)


def test_port_adds_only_the_listed_flags():
    extra = {}
    for rel, ref, ours in _cli_modules():
        known = {n for names in ref for n in names}
        extra.update({(rel, n): names for names in ours for n in names if n not in known})
    listed = {(rel, flag) for rel, flags in EXTRA_FLAGS.items() for flag in flags}
    assert set(extra) == listed, f"flags beyond fhetpu's: {sorted(extra)}, listed: {sorted(listed)}"
