"""Each C entry point of the port's CUDA sources against its ctypes binding, on the CPU.

The kernels are loaded with ctypes (`ops/cuda/_build.py`), which trusts the argument
types a binding declares: one argument too few, or an int where the C side takes a
pointer, shifts or truncates every argument after it on the card, with no error. This
test parses every ``extern "C"`` entry point of ``csrc/*.cu`` and holds it to the
``argtypes`` that the bind function of the wrapper module that loads the source
declares for it.
"""
import ast
import ctypes
import importlib
import re
import types
from pathlib import Path

import pytest

from lit_llama_ja_tpu_torch.ops.cuda import _build

OPS_CUDA = Path(_build.__file__).resolve().parent
C_SCALARS = {"int": ctypes.c_int, "long long": ctypes.c_longlong, "float": ctypes.c_float}


def c_entry_points(path: Path):
    """name -> ctypes types of the parameters of each ``int lljt_*(...)`` definition."""
    text = re.sub(r"//[^\n]*", "", path.read_text())
    out = {}
    for name, params in re.findall(r"\bint\s+(lljt_\w+)\s*\(([^)]*)\)\s*\{", text):
        types_ = []
        for p in filter(None, (p.strip() for p in params.split(","))):
            if "*" in p:
                types_.append(ctypes.c_void_p)
            else:
                words = [w for w in p.split()[:-1] if w != "const"]
                types_.append(C_SCALARS[" ".join(words)])
        out[name] = types_
    return out


class _Recorder:
    """Stands in for a loaded library: records what a bind function declares."""

    def __init__(self):
        self.fns = {}

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        return self.fns.setdefault(name, types.SimpleNamespace())


def binders():
    """source name -> the bind function its wrapper module passes to `_build.load`."""
    out = {}
    for path in sorted(OPS_CUDA.glob("*.py")):
        module = None
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "load" and isinstance(node.func.value, ast.Name)
                    and node.func.value.id == "_build"):
                source, fn = node.args
                module = module or importlib.import_module(
                    f"lit_llama_ja_tpu_torch.ops.cuda.{path.stem}")
                out[source.value] = getattr(module, fn.id)
    return out


def declared(bind):
    lib = _Recorder()
    bind(lib)
    return lib.fns


def test_every_source_is_built_and_loaded():
    on_disk = {p.stem for p in _build.CSRC.glob("*.cu")}
    assert on_disk == set(_build.SOURCES)
    assert set(binders()) == on_disk


@pytest.mark.parametrize("source", _build.SOURCES)
def test_bindings_match_the_c_signatures(source):
    want = c_entry_points(_build.CSRC / f"{source}.cu")
    got = declared(binders()[source])
    assert want and set(got) == set(want), (sorted(got), sorted(want))
    for name, params in want.items():
        assert got[name].argtypes == params, (name, got[name].argtypes, params)
        assert got[name].restype == ctypes.c_int, name


def test_probe_binds_as_the_wrappers_do():
    probe = importlib.import_module("lit_llama_ja_tpu_torch.ops.cuda.gemm_probe")
    wrappers = binders()
    assert probe.LIBS and all(probe.LIBS[s] is wrappers[s] for s in probe.LIBS)
