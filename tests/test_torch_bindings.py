"""The port's C entry points (``hmsc_tpu_torch/csrc/*.cu``, ``extern "C"``)
against their ctypes bindings (``hmsc_tpu_torch/kernels``): each bound
function exists in the sources and declares as many arguments as it is
bound with.  ctypes checks neither when the library loads, and a call
with one argument too many or too few fails only on the card."""

import ctypes
import re
import textwrap

import pytest

from hmsc_tpu_torch import kernels as K

pytestmark = pytest.mark.torch


def _parameters():
    """{name: [parameter declarations]} of every ``extern "C" int`` in
    csrc/."""
    out = {}
    for f in K._CSRC.glob("*.cu"):
        for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)',
                             f.read_text()):
            out[m.group(1)] = [" ".join(a.split())
                               for a in m.group(2).split(",") if a.strip()]
    return out


def _entry_points():
    """{name: parameter count} of every ``extern "C" int`` in csrc/."""
    return {k: len(v) for k, v in _parameters().items()}


# a C parameter's type -> the ctypes type it must be bound with
_CTYPE = {"int": ctypes.c_int, "unsigned": ctypes.c_uint,
          "long long": ctypes.c_longlong,
          "unsigned long long": ctypes.c_ulonglong, "float": ctypes.c_float}


def _bindings():
    """{name: argtypes} as ``kernels.library`` sets them, read from its
    source without building the library."""
    import inspect

    src = inspect.getsource(K.library)
    body = src[src.index("lib.hmsc_probit_z.argtypes"):
               src.index("for fn in (")]

    class _Fn:
        argtypes = None

    class _Lib:
        def __getattr__(self, name):
            fn = _Fn()
            object.__setattr__(self, name, fn)
            return fn

    lib = _Lib()
    exec(textwrap.dedent("    " * 3 + body),
         {"lib": lib, "ctypes": ctypes, "p": ctypes.c_void_p,
          "i": ctypes.c_int, "ll": ctypes.c_longlong,
          "u64": ctypes.c_ulonglong, "u32": ctypes.c_uint})
    return {k: v.argtypes for k, v in vars(lib).items()}


def test_every_binding_matches_its_entry_point():
    entries, bound = _entry_points(), _bindings()
    assert set(bound) == set(entries)
    for name, argtypes in bound.items():
        assert len(argtypes) == entries[name], name


def test_every_kernel_has_a_source():
    for name, src in K.KERNELS.items():
        assert (K._CSRC / src).exists(), name


def test_every_binding_has_its_parameters_types():
    """Each bound argument's ctypes type matches its C parameter's: a
    pointer as c_void_p, an int as c_int, a float as c_float, and so on
    (ctypes converts a Python float for a c_int argument silently)."""
    params, bound = _parameters(), _bindings()
    for name, argtypes in bound.items():
        for decl, ct in zip(params[name], argtypes):
            want = (ctypes.c_void_p if "*" in decl
                    else _CTYPE[decl.rsplit(" ", 1)[0]])
            assert ct is want, f"{name}: {decl} bound as {ct}"
