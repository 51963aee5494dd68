"""The public surface of the port against the JAX package's, on the CPU:
the names of ``aesara_tpu_torch`` and of ``aesara_tpu_torch.tensor``,
``TensorVariable``'s public methods, and the parameters of ``function``,
``shared``, ``verify_grad``, ``argmax``, ``prod`` and ``tensor``.

``LEFT_OUT`` is the one list of what the port leaves out on purpose, each
entry with its reason and the ROADMAP queue item that brings it; any other
name the JAX package has and the port lacks fails.  ``PORT_ONLY`` lists
the names the port adds, each with its reason.  Submodules and the
``typing`` names a star import carries are not part of a surface.
"""

import importlib.util
import inspect
import types
import typing

import pytest

import aesara_tpu
import aesara_tpu.tensor as jat
from aesara_tpu.tensor.var import TensorVariable as JTensorVariable

import aesara_tpu_torch
import aesara_tpu_torch.tensor as pat
from aesara_tpu_torch.tensor.var import TensorVariable as PTensorVariable

COMPLEX = "4c: complex dtypes and their scalar ops"
SERIES = "4b: the series special functions (no libdevice form)"
LINALG = "12: nlinalg, slinalg, fft, searchsorted, xlogx"
DIAGNOSTICS = "15: diagnostics and the graph printers"
PARALLEL = "16: parallel"
NO_FALLBACK = "no fallback by rule: the port has one linker"

_COMPLEX_CTORS = [f"{p}{base}{s}" for p in "cz" for base in ("scalar", "vector", "row", "col", "tensor3", "tensor4",
                                                                "tensor5", "tensor6", "tensor7")
                  for s in ("", "s")] + ["cmatrix", "cmatrices", "zmatrix", "zmatrices"]

#: {(where, name): reason}: where is "top", "tensor", "method" or a
#: function's parameter ("function(profile)")
LEFT_OUT = {
    **{("tensor", n): COMPLEX for n in _COMPLEX_CTORS + ["angle", "complex", "complex_from_polar", "conj",
                                                         "conjugate", "real", "imag"]},
    **{("method", n): COMPLEX for n in ("conj", "conjugate", "real", "imag")},
    **{("tensor", n): SERIES for n in ("betainc", "chi2sf", "gammainc", "gammaincc", "gammal", "gammau", "hyp2f1",
                                       "hyp2f1_der", "iv", "jv", "owens_t")},
    ("method", "searchsorted"): LINALG,
    **{("top", n): DIAGNOSTICS for n in ("ProfileStats", "debugprint", "dprint", "pp", "pprint")},
    ("function(profile)", "truthy"): DIAGNOSTICS,
    ("tensor(sharding)", "not None"): PARALLEL,
    ("top", "JAX"): NO_FALLBACK, ("top", "PY"): NO_FALLBACK,
    **{("module", n): LINALG for n in ("tensor.nlinalg", "tensor.slinalg", "tensor.fft", "tensor.xlogx")},
    ("module", "typed_list"): "14: typed_list",
    ("module", "parallel"): PARALLEL,
}

#: {(where, name): reason} of the names only the port has
PORT_ONLY = {
    ("top", "TORCH"): "the port's mode: FAST_RUN's rewrites on TorchLinker",
    ("top", "TorchLinker"): "the port's linker",
    ("tensor", "softmax"): "exported at the root since the first slice",
    ("tensor", "log_softmax"): "exported at the root since the first slice",
    ("tensor", "fused_attention"): "exported at the root since the first slice",
}

MODULES = (types.ModuleType,)


def _public(module) -> set:
    out = set()
    for name in dir(module):
        if name.startswith("_"):
            continue
        value = getattr(module, name)
        if isinstance(value, MODULES) or getattr(value, "__module__", None) in ("typing", "__future__"):
            continue
        if name == "annotations" or value in (typing.Optional, typing.Union, typing.Sequence):
            continue
        out.add(name)
    return out


def _shadowed(module, name) -> bool:
    """Whether the JAX package's ``module.name`` is a submodule where the
    package binds a function of that name: importing
    ``aesara_tpu.assert_op`` (as another test file does) rebinds
    ``aesara_tpu.assert_op`` to the module, so in a worker that ran that
    file first the name is not the package's function, and a comparison of
    the two packages' names would depend on the order the files ran in.
    The port's names get no such pass: a port name that is a module where
    the JAX package's is a function is a fault."""
    return module is not None and isinstance(getattr(module, name, None), MODULES)


def _diff(where, jax_names, port_names, jax=None):
    missing = {n for n in jax_names - port_names if (where, n) not in LEFT_OUT}
    extra = {n for n in port_names - jax_names if (where, n) not in PORT_ONLY and not _shadowed(jax, n)}
    stale = {n for (w, n) in LEFT_OUT if w == where and n in port_names}
    return missing, extra, stale


@pytest.mark.parametrize("where,jax,port", [("top", aesara_tpu, aesara_tpu_torch), ("tensor", jat, pat)],
                         ids=["top", "tensor"])
def test_the_namespaces_match_but_the_listed_leave_outs(where, jax, port):
    missing, extra, stale = _diff(where, _public(jax), _public(port), jax)
    assert not missing, f"names of the JAX package's {where} namespace the port lacks: {sorted(missing)}"
    assert not extra, f"names only the port's {where} namespace has, unlisted: {sorted(extra)}"
    assert not stale, f"listed as left out but present: {sorted(stale)}"


def test_tensor_variable_has_the_jax_packages_methods_but_the_listed_leave_outs():
    names = [{n for n in dir(cls) if not n.startswith("_")} for cls in (JTensorVariable, PTensorVariable)]
    missing, extra, stale = _diff("method", *names)
    assert not (missing or extra or stale), (sorted(missing), sorted(extra), sorted(stale))


def _params(fn):
    return [p for p in inspect.signature(fn).parameters]


SIGNATURES = {
    "function": (aesara_tpu.function, aesara_tpu_torch.function, ["device"]),
    "shared": (aesara_tpu.shared, aesara_tpu_torch.shared, ["device"]),
    "verify_grad": (aesara_tpu.verify_grad, aesara_tpu_torch.verify_grad, []),
    "argmax": (jat.argmax, pat.argmax, []),
    "prod": (jat.prod, pat.prod, []),
    "tensor": (jat.tensor, pat.tensor, []),
}


@pytest.mark.parametrize("name", sorted(SIGNATURES))
def test_signatures_take_the_jax_packages_parameters_in_its_order(name):
    """The port's parameters are the JAX package's, in its order, with the
    port's own listed ones (``device``) before any ``**kwargs``."""
    jax_fn, port_fn, own = SIGNATURES[name]
    want, got = _params(jax_fn), [p for p in _params(port_fn) if p not in own]
    assert got == want, (got, want)


def test_the_left_out_parameters_refuse_to_run():
    x = pat.vector("x")
    with pytest.raises(NotImplementedError, match="item 15"):
        aesara_tpu_torch.function([x], x, profile=True)
    with pytest.raises(NotImplementedError, match="item 16"):
        pat.tensor("y", shape=(2,), sharding=("dp",))
    assert set(LEFT_OUT.values()) == {COMPLEX, SERIES, LINALG, DIAGNOSTICS, PARALLEL, NO_FALLBACK,
                                      "14: typed_list"}


@pytest.mark.parametrize("path", sorted(n for w, n in LEFT_OUT if w == "module"))
def test_the_left_out_modules_are_the_jax_packages_alone(path):
    assert importlib.util.find_spec(f"aesara_tpu.{path}") is not None
    assert importlib.util.find_spec(f"aesara_tpu_torch.{path}") is None
