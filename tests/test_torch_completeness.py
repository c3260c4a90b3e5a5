"""Does the port do all that jrc_tpu does? Each public top-level name that a
jrc_tpu module defines (functions, classes, constants; read with ``ast``,
so jax is not imported) must exist in the port's module at the same path,
or stand in ``COUNTERPARTS``: a name of the port that does the same under
another name or path, or the reason why nothing in the port needs it. A
name that is neither found nor mapped fails, and so does a mapping that no
longer maps a missing name or names a port function that is not there."""
import ast
import importlib
from pathlib import Path

import pytest

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
