"""Does the port do all that jrc_tpu does? Each public top-level name that a
jrc_tpu module defines (functions, classes, constants; read with ``ast``,
so jax is not imported) must exist in the port's module at the same path,
or stand in ``COUNTERPARTS``: a name of the port that does the same under
another name or path, or the reason why nothing in the port needs it. A
name that is neither found nor mapped fails, and so does a mapping that no
longer maps a missing name or names a port function that is not there.

The same walk then goes down to arguments: each parameter of a public
function, of a public method or ``__init__`` of a public class, and each
field of a result NamedTuple or dataclass, must be a parameter of the port's
twin or stand in ``DROPPED_ARGS`` with its reason; a default that both
packages give must be the same value."""
import ast
import importlib
import inspect
from pathlib import Path

import pytest
from tests.torch_parity import THREADS  # noqa: F401 (the one-thread pool)

ROOT = Path(__file__).resolve().parents[1]
REFERENCE = ROOT / "jrc_tpu"

NO_COMPLEX_DATAPATH = ("no port: the (re, im) pair form, its arithmetic and DFT-as-matmul exist "
                       "because the TPU has no complex datapath; the port computes on "
                       "torch.complex64 with torch.fft")
TPU_TILING = ("no port: a tile constant of the Pallas kernel's TPU layout; the CUDA kernel "
              "sets its own launch geometry")

#: reference name → port name ("module.name" under jrc_tpu_torch) or "no port: <reason>";
#: "module.*" stands for every public name of the module
COUNTERPARTS = {
    "ops.cplx.*": NO_COMPLEX_DATAPATH,
    "ops.modulation.constellation_pair": "ops.modulation.constellation",
    "ops.detect_pallas.detect_front_end": "ops.detect_cuda.detect_front_end",
    "ops.detect_pallas.LANE": TPU_TILING,
    "ops.detect_pallas.CHUNK_ROWS": TPU_TILING,
    "ops.gather_pallas.gather_rows": "ops.gather_cuda.gather_rows",
    "ops.gather_pallas.GROUP": TPU_TILING,
    "ops.gather_pallas.LANE": TPU_TILING,
    "ops.viterbi_pallas.viterbi_decode_pallas": "ops.viterbi_cuda.viterbi_decode",
    "ops.viterbi_pallas.LANE": TPU_TILING,
    "ops.viterbi_pallas.GRID_T": TPU_TILING,
    # the scan decoder: the plain version that the fused kernel's wrapper runs on a CPU tensor
    "ops.viterbi.viterbi_decode": "ops.viterbi_cuda.viterbi_decode",
    "ops.viterbi.decode_bits": "ops.decoder.decode_bits",
    "parallel.streaming.make_time_mesh": "parallel.mesh.time_mesh",
    "utils.cache.enable_compile_cache": ("no port: XLA only (it points jax's persistent "
                                         "compile cache at a directory); see utils/cache.py, "
                                         "whose fingerprint keys the port's builds"),
    "utils.profiling.Throughput": ("no port: it waits for the device at every read; the port "
                                   "times its host steps with utils.profiling.span and each "
                                   "captured call's device time with utils.profiling.DeviceClock, "
                                   "without a synchronize"),
    "utils.profiling.trace": ("no port: the port records its spans timeline with "
                              "utils.profiling.recording and merges it into a device-only "
                              "torch.profiler trace (utils.profiling.CallTrace, the apps' "
                              "--trace-out)"),
}


def _module_name(path: Path) -> str:
    parts = path.relative_to(REFERENCE).with_suffix("").parts
    return ".".join(p for p in parts if p != "__init__")


MODULES = sorted((_module_name(p), p) for p in REFERENCE.rglob("*.py"))


def public_names(path: Path) -> list[str]:
    """The public names a module's top level defines."""
    names = []
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.append(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for t in targets:
                names += [e.id for e in ast.walk(t) if isinstance(e, ast.Name)]
    return [n for n in names if not n.startswith("_")]


def port_module(name: str):
    try:
        return importlib.import_module("jrc_tpu_torch" + (f".{name}" if name else ""))
    except ModuleNotFoundError:
        return None


def port_has(path: str) -> bool:
    """Does "module.name" resolve under jrc_tpu_torch?"""
    module, _, name = path.rpartition(".")
    mod = port_module(module)
    return mod is not None and hasattr(mod, name)


def missing(module: str, path: Path) -> list[str]:
    """The module's public names the port's module at the same path lacks."""
    mod = port_module(module)
    return [n for n in public_names(path) if mod is None or not hasattr(mod, n)]


def counterpart(module: str, name: str) -> str | None:
    return COUNTERPARTS.get(f"{module}.{name}", COUNTERPARTS.get(f"{module}.*"))


@pytest.mark.parametrize("module,path", MODULES, ids=[m or "jrc_tpu" for m, _ in MODULES])
def test_every_public_name_is_ported_or_mapped(module, path):
    for name in missing(module, path):
        target = counterpart(module, name)
        assert target is not None, f"jrc_tpu.{module}.{name} has no counterpart in the port"
        if not target.startswith("no port: "):
            assert port_has(target), f"jrc_tpu.{module}.{name} → {target}: not in the port"


def test_every_mapping_maps_a_missing_name():
    """No stale entry: each key names a module of jrc_tpu and, unless it is
    "module.*", a public name of it that the port's module lacks."""
    modules = dict(MODULES)
    for key in COUNTERPARTS:
        module, _, name = key.rpartition(".")
        assert module in modules, key
        gaps = missing(module, modules[module])
        assert gaps if name == "*" else name in gaps, key


def test_the_walk_sees_the_reference():
    """The walk reads every module, and a name that is only in the reference
    would be caught."""
    names = dict(MODULES)
    assert {"ops.viterbi", "ops.coding", "runtime", "utils.cache", "utils.logging",
            "models.jrc_trx", "parallel.streaming"} <= set(names)
    assert "viterbi_decode_chunked" in public_names(names["ops.viterbi"])
    assert "interleave" in public_names(names["ops.coding"])
    assert "mean_power" in public_names(names["runtime"])
    assert counterpart("ops.viterbi", "viterbi_decode_chunked") is None
    assert port_has("ops.viterbi.viterbi_decode_chunked")
    assert not port_has("ops.viterbi.no_such_function")


# ------------------------------------------------------------------ arguments

PRNG_KEY = ("a jax PRNG key: the port takes its draws as tensors or from a torch.Generator "
            "(comm_link.Draws, generator=)")
PREBUILT_TABLES = ("the port reads it from the prebuilt tables it is handed (tables.Tables, "
                   "config.OFDMConfig's masks) instead of rebuilding them from the argument")
RADAR_TABLES = ("interpolation factors and windows are fixed when the port's RadarTables or "
                "taper_* are built, not passed per call")
VITERBI_BACKEND = ("the device rule picks the decoder: K1 on a CUDA tensor, its plain version "
                   "on a CPU tensor")
TPU_ONLY = "TPU or XLA only: the Pallas interpret mode or the XLA scan's unroll option"
PAIR_FORM = ("the reference's (re, im) float pair of the TPU layout; the port takes one "
             "complex64 tensor x")

#: "module.function" or "module.Class.method" of jrc_tpu → {argument: reason} for each
#: argument that the port's twin does not take
DROPPED_ARGS = {
    "models.comm_link.loopback": {"key": PRNG_KEY},
    "models.comm_link.tx_frame": {"rng_key": PRNG_KEY},
    "models.jrc_trx.jrc_tx": {"key": PRNG_KEY},
    "models.jrc_trx.jrc_radar_rx": {"interp_factor_range": RADAR_TABLES,
                                    "interp_factor_angle": RADAR_TABLES,
                                    "window_range": RADAR_TABLES},
    "models.jrc_trx.jrc_step": {"key": PRNG_KEY, "interp_factor_range": RADAR_TABLES,
                                "interp_factor_angle": RADAR_TABLES, "window_range": RADAR_TABLES},
    "models.radar_chain.radar_frame": {"key": PRNG_KEY, "interp_factor_range": RADAR_TABLES,
                                       "interp_factor_angle": RADAR_TABLES,
                                       "window_range": RADAR_TABLES},
    "models.streaming.scan_rx": {"viterbi_backend": VITERBI_BACKEND},
    "models.streaming.flat_rx": {"viterbi_backend": VITERBI_BACKEND},
    "models.streaming.scan_rx_dynamic": {"viterbi_backend": VITERBI_BACKEND},
    "models.streaming.flat_rx_dynamic": {"viterbi_backend": VITERBI_BACKEND},
    "ops.channel.apply_targets": {"rng_key": PRNG_KEY},
    "ops.channel.awgn": {"rng_key": PRNG_KEY},
    "ops.channel.comm_channel": {"rng_key": PRNG_KEY},
    "ops.coding.crc32_check_residue": {"payload_with_fcs": "renamed data (the payload with "
                                                           "its FCS, as before)"},
    "ops.detect_pallas.detect_front_end": {"xr": PAIR_FORM, "xi": PAIR_FORM,
                                           "interpret": TPU_ONLY},
    "ops.dynamic_rx.frame_geometry": {"n_data_carriers": PREBUILT_TABLES},
    "ops.dynamic_rx.payload_values_dynamic": {"n_data_carriers": PREBUILT_TABLES},
    "ops.dynamic_rx.rx_frame_dynamic": {"trigger": "renamed triggers (the detector's trigger "
                                                   "positions)"},
    "ops.dynamic_rx.rx_frame_dynamic_values": {"trigger": "renamed triggers (the detector's "
                                                          "trigger positions)"},
    "ops.equalizer.common_phase_error": {"cfg": PREBUILT_TABLES},
    "ops.equalizer.legacy_channel_estimate": {"cfg": PREBUILT_TABLES},
    "ops.equalizer.mimo_channel_estimate_ndp": {"cfg": PREBUILT_TABLES},
    "ops.equalizer.equalize_data_symbols": {
        "h_legacy": "the port takes h0, the one estimate the caller chose as "
                    "jrc_tpu/ops/equalizer.py:142 chooses between h_legacy and h_eff",
        "h_eff": "see h_legacy: both are replaced by the chosen h0"},
    "ops.gather_pallas.gather_rows": {"interpret": TPU_ONLY},
    "ops.modulation.hard_decision": {"mcs": PREBUILT_TABLES},
    "ops.modulation.modulate": {"mcs": PREBUILT_TABLES},
    "ops.modulation.soft_llr": {"mcs": PREBUILT_TABLES},
    "ops.ofdm.extract_data_carriers": {"cfg": PREBUILT_TABLES},
    "ops.ofdm.extract_pilot_carriers": {"cfg": PREBUILT_TABLES},
    "ops.ofdm.zero_pad": {"rng_key": PRNG_KEY},
    "ops.precoder.assemble_frame": {"rng_key": PRNG_KEY},
    "ops.radar.range_angle_map": {"window_range": RADAR_TABLES, "window_angle": RADAR_TABLES},
    "ops.viterbi.viterbi_decode": {"unroll": TPU_ONLY},
    "ops.viterbi_pallas.viterbi_decode_pallas": {"interpret": TPU_ONLY},
    "parallel.mesh.time_mesh": {"devices": "the port's mesh is a torch.distributed group: each "
                                           "rank names its one device"},
    "parallel.streaming.make_time_mesh": {"devices": "as parallel.mesh.time_mesh"},
    "parallel.streaming.sharded_rx": {"samples": "renamed block: each rank is handed its own "
                                                 "block, not the whole stream"},
    "parallel.streaming.sharded_rx_dynamic": {"samples": "renamed block: each rank is handed its "
                                                         "own block, not the whole stream"},
}

NO_DEFAULT = object()


def _is_record(node: ast.ClassDef) -> bool:
    return (any("NamedTuple" in ast.unparse(b) for b in node.bases)
            or any("dataclass" in ast.unparse(d) for d in node.decorator_list))


def _params(args: ast.arguments) -> list[tuple[str, ast.expr | None]]:
    """(name, default expression or None) of each parameter but self/cls."""
    pos = args.posonlyargs + args.args
    defaults = [None] * (len(pos) - len(args.defaults)) + list(args.defaults)
    pairs = list(zip(pos, defaults)) + list(zip(args.kwonlyargs, args.kw_defaults))
    return [(a.arg, d) for a, d in pairs if a.arg not in ("self", "cls")]


def signatures(path: Path) -> list[tuple[str, list[tuple[str, ast.expr | None]] | None]]:
    """(qualified name, parameters) of each public function, each public
    method and __init__ of a public class, and each record's fields (under
    the class's own name); a property has None for parameters."""
    out = []
    for node in ast.parse(path.read_text()).body:
        if getattr(node, "name", "_").startswith("_"):
            continue
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.append((node.name, _params(node.args)))
        elif isinstance(node, ast.ClassDef):
            if _is_record(node):
                out.append((node.name, [(f.target.id, f.value) for f in node.body
                                        if isinstance(f, ast.AnnAssign)
                                        and not f.target.id.startswith("_")]))
            for sub in node.body:
                if (isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef))
                        and (sub.name == "__init__" or not sub.name.startswith("_"))):
                    prop = any("property" in ast.unparse(d) for d in sub.decorator_list)
                    out.append((f"{node.name}.{sub.name}", None if prop else _params(sub.args)))
    return out


def constants(path: Path) -> dict:
    """The module's top-level names bound to a literal (what a default may name)."""
    out = {}
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and isinstance(node.targets[0], ast.Name):
            try:
                out[node.targets[0].id] = ast.literal_eval(node.value)
            except ValueError:
                pass
    return out


#: the builtins a default may call (config.OFDMConfig's data carriers are a tuple of ranges)
PURE_BUILTINS = {"tuple": tuple, "list": list, "range": range}


def default_value(expr: ast.expr, consts: dict):
    """The value of a default written as a literal, or as an expression of
    literals, the module's literal constants and PURE_BUILTINS (``1 << 17``,
    ``DEFAULT_PORT``, ``tuple(list(range(-26, -21)) + ...)``)."""
    try:
        return ast.literal_eval(expr)
    except ValueError:
        pass
    nodes = list(ast.walk(expr))
    assert not any(isinstance(n, ast.Attribute) for n in nodes), ast.unparse(expr)
    assert {n.id for n in nodes if isinstance(n, ast.Name)} <= consts.keys() | PURE_BUILTINS.keys(), \
        ast.unparse(expr)
    return eval(compile(ast.Expression(expr), "<default>", "eval"),
                {"__builtins__": {}, **PURE_BUILTINS}, consts)


def port_twin(module: str, qualname: str):
    """The port's object for a reference function, method, property or record
    (at the same path or through COUNTERPARTS), or None when the name has no port."""
    top, _, member = qualname.partition(".")
    obj = getattr(port_module(module), top, None)
    if obj is None:
        target = counterpart(module, top)
        if target.startswith("no port: "):
            return None
        where, _, name = target.rpartition(".")
        obj = getattr(port_module(where), name)
    if member:
        assert hasattr(obj, member), f"jrc_tpu.{module}.{qualname}: the port's twin lacks it"
        obj = inspect.getattr_static(obj, member)
        obj = obj.__func__ if isinstance(obj, (staticmethod, classmethod)) else obj
    return obj


def port_params(obj) -> dict:
    """The port's parameters → default (NO_DEFAULT where it has none)."""
    return {n: (NO_DEFAULT if p.default is inspect.Parameter.empty else p.default)
            for n, p in inspect.signature(obj).parameters.items()}


def argument_gaps(params, twin, consts) -> tuple[list[str], list[str]]:
    """(the reference's parameters the twin lacks, the shared defaults that differ)."""
    theirs = port_params(twin)
    dropped = [n for n, _ in params if n not in theirs]
    differ = []
    for n, expr in params:
        if expr is None or theirs.get(n, NO_DEFAULT) is NO_DEFAULT:
            continue
        want, got = default_value(expr, consts), theirs[n]
        if type(want) is not type(got) or want != got:
            differ.append(f"{n}: {want!r} in jrc_tpu, {got!r} in the port")
    return dropped, differ


@pytest.mark.parametrize("module,path", MODULES, ids=[m or "jrc_tpu" for m, _ in MODULES])
def test_every_argument_is_taken_or_dropped_for_a_reason(module, path):
    consts = constants(path)
    for qualname, params in signatures(path):
        twin = port_twin(module, qualname)
        if twin is None or params is None:
            continue
        dropped, differ = argument_gaps(params, twin, consts)
        reasons = DROPPED_ARGS.get(f"{module}.{qualname}", {})
        unexplained = [n for n in dropped if not reasons.get(n)]
        assert not unexplained, f"jrc_tpu.{module}.{qualname}: the port drops {unexplained}"
        assert not differ, f"jrc_tpu.{module}.{qualname}: defaults differ: {differ}"


def test_every_dropped_arg_is_really_dropped():
    """No stale entry: each key names a reference function of a twin, and
    each argument is one the reference takes and the twin does not."""
    modules = dict(MODULES)
    for key, reasons in DROPPED_ARGS.items():
        module = next(m for m in sorted(modules, key=len, reverse=True)
                      if key.startswith(f"{m}."))
        qualname = key[len(module) + 1:]
        params = dict(signatures(modules[module])).get(qualname)
        assert params, key
        twin = port_twin(module, qualname)
        assert twin is not None, key
        dropped, _ = argument_gaps(params, twin, constants(modules[module]))
        assert set(reasons) <= set(dropped), (key, set(reasons) - set(dropped))


def test_the_argument_walk_would_catch_a_drop():
    """A twin that lost noise_var, or changed a default, is caught; the
    soft-decision path takes the reference's noise_var."""
    names = dict(MODULES)
    params = dict(signatures(names["ops.decoder"]))["decode_frame"]

    def lost(spec, tab, z, soft=False):
        pass

    def changed(spec, tab, z, soft=True, noise_var=1.0):
        pass

    assert argument_gaps(params, lost, {}) == (["noise_var"], [])
    assert argument_gaps(params, changed, {})[1] == ["soft: False in jrc_tpu, True in the port"]
    for module, name in [("ops.modulation", "soft_llr"), ("ops.decoder", "frame_values"),
                         ("ops.decoder", "decode_frame")]:
        assert port_params(port_twin(module, name))["noise_var"] == 1.0
        assert "noise_var" not in DROPPED_ARGS.get(f"{module}.{name}", {})
    sigs = dict(signatures(names["config"]))
    assert sigs["OFDMConfig.data_mask"] is None  # a property: its presence is checked
    assert [n for n, _ in dict(signatures(names["ops.decoder"]))["DecodedFrame"]] == [
        "payload", "crc_ok", "scrambler_seed"]


# ------------------------------------------------ multi-chip entry points

#: the reference's multi-chip entry points outside jrc_tpu/ → the port's twin, each
#: "file:function"; the twin calls every sharded executor that the reference calls
MULTICHIP_TWINS = {
    "__graft_entry__.py:dryrun_multichip": "jrc_tpu_torch/parallel/dryrun.py:dryrun",
    "scripts/multihost_rx.py:main": "scripts/multihost_rx_torch.py:main",
}
EXECUTORS = {"sharded_rx", "sharded_rx_dynamic", "batched_rx", "batched_range_angle_maps"}


def _function(where: str) -> ast.FunctionDef:
    path, _, name = where.partition(":")
    tree = ast.parse((ROOT / path).read_text())
    found = [n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == name]
    assert found, f"{where}: no such function"
    return found[0]


def _called(fn: ast.FunctionDef) -> set[str]:
    """The names that ``fn`` calls, bare or as an attribute."""
    return {c.func.attr if isinstance(c.func, ast.Attribute) else getattr(c.func, "id", "")
            for c in ast.walk(fn) if isinstance(c, ast.Call)}


@pytest.mark.parametrize("ref,twin", MULTICHIP_TWINS.items(), ids=list(MULTICHIP_TWINS))
def test_every_multichip_entry_point_has_its_twin(ref, twin):
    """Both functions exist, and the twin calls each sharded executor that
    the reference calls."""
    want, got = _called(_function(ref)) & EXECUTORS, _called(_function(twin))
    assert want and want <= got, (twin, want - got)
