"""The port's public surface held equal to the JAX package's.

For every module of ``linrad_tpu`` and its counterpart under
``linrad_tpu_torch``:

- each public top-level name of the JAX module exists in the port (for a
  package: each name its ``__init__.py`` exports);
- each public method of each public class exists on the port's class,
  inherited ones included (``inspect.getmembers``);
- each parameter of each public function, class constructor and method
  exists in the port's signature, of the same kind; a positional one
  stands at JAX's index, so a call written for the JAX package binds
  the same arguments.  The port may take more (``device``, keyword-only
  options).

What the port leaves out or names otherwise is in ``EXCEPTIONS``, each
with its reason, and every entry there must still be needed.  A
parameter of the JAX package may be left out only when nothing in the
JAX package, ``tools/``, ``examples/`` or ``bench.py`` passes it (its
own tests of the option do not count); the test reads their calls to
hold that.  Positional parameters after one left out are keyword-only
in the port, so that a call written for the JAX package fails instead
of binding an argument to the wrong name.
"""

import __future__
import ast
import functools
import importlib
import inspect
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
CALLER_TREES = ("linrad_tpu", "tools", "examples", "bench.py")
UNCALLED = ("an option of the JAX package that nothing there passes "
            "(checked by test_left_out_parameter_has_no_caller)")

EXCEPTIONS = {
    # modules with no counterpart
    "linrad_tpu.ops.cplx":
        "float-pair complex helpers, a workaround for the TPU backend's "
        "complex-indexing faults; the port uses native complex64",
    "linrad_tpu.ops.pallas_fft":
        "the Pallas TPU kernel; its counterpart is the CUDA kernel "
        "csrc/fused_fft1.cu behind ops/fused_fft1.py",
    "linrad_tpu.utils.pytree":
        "a jax.tree_util registration decorator; the port's states are "
        "plain dataclasses (pipeline/batch.tensor_leaves walks them)",
    "linrad_tpu.utils.xfer":
        "float-pair host-to-device transfers, the same TPU workaround as "
        "ops/cplx",
    # top-level names with no counterpart
    "AXIS":
        "the name of a jax.sharding mesh axis; the port's parallel modules "
        "take a group of shards (parallel/group.py), which names no axis",
    # parameters named in torch's idiom: jax name -> port name
    "axis->dim": "torch names the axis a function works along dim",
    "mesh->group":
        "a jax Mesh becomes a parallel/group.py LocalGroup or DistGroup",
    "axis_name->reduce":
        "a collective over a named mesh axis becomes a callable that "
        "reduces the list of the shards' values (fft1_step)",
    "devices->device":
        "torch's word; FleetRunner's device takes one device or a list",
    "device":
        "the port's own parameter, placed by its idiom: second in the "
        "constructors (FFT2State.create(geo, device)), keyword-only "
        "elsewhere; it stands outside the index check, since torch needs "
        "the device named where the JAX package uses its default",
    "segment_reduce: op->reduce":
        "torch's name for the reduction (torch.segment_reduce, "
        "Tensor.scatter_reduce)",
    "StepTimer.stop: arrays->tensors":
        "the timer waits for torch tensors where the JAX one blocks on "
        "arrays",
    # parameters left out: qualified name(parameter)
    "fft2_transform(variant)": UNCALLED + "; the stage's FFT is torch.fft",
    "fft2_step(variant)": UNCALLED,
    "timf2_step(variant)": UNCALLED,
    "fft3_step(variant)": UNCALLED,
    "mix1_step(variant)": UNCALLED,
    "mix2_step(variant)": UNCALLED,
    "mix2_carrier_step(variant)": UNCALLED,
    "one_pole(b)":
        UNCALLED + "; every caller passes a scalar coefficient, so the "
        "port's scans also take a and decay as Python floats only",
    "Receiver.run(progress)": UNCALLED + "; no line of the JAX run reads it",
}
LEFT_OUT = {k for k in EXCEPTIONS if re.fullmatch(r"[\w.]+\(\w+\)", k)}

RENAMES = {}
for _key in EXCEPTIONS:
    if "->" in _key:
        _scope, _, _pair = _key.rpartition(": ")
        _old, _new = _pair.split("->")
        RENAMES[(_scope, _old)] = _new


def _module_names() -> list[str]:
    names = []
    for path in sorted((ROOT / "linrad_tpu").rglob("*.py")):
        parts = list(path.relative_to(ROOT).with_suffix("").parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        names.append(".".join(parts))
    return names


JAX_MODULES = _module_names()


def _port_name(name: str) -> str:
    return "linrad_tpu_torch" + name[len("linrad_tpu"):]


def _defined_here(mod, obj) -> bool:
    """A public attribute of the module itself: not a module, not a
    __future__ flag, not a function or class imported from elsewhere."""
    if inspect.ismodule(obj) or isinstance(obj, __future__._Feature):
        return False
    if callable(obj):
        return getattr(obj, "__module__", mod.__name__) == mod.__name__
    return True


def _public(mod) -> dict:
    if hasattr(mod, "__path__"):  # a package: what its __init__ exports
        names = set(getattr(mod, "__all__", ()))
        names |= {k for k, v in vars(mod).items()
                  if not k.startswith("_") and not inspect.ismodule(v)
                  and not isinstance(v, __future__._Feature)}
        return {k: getattr(mod, k) for k in sorted(names)}
    return {k: v for k, v in vars(mod).items()
            if not k.startswith("_") and _defined_here(mod, v)}


POSITIONAL = (inspect.Parameter.POSITIONAL_ONLY,
              inspect.Parameter.POSITIONAL_OR_KEYWORD)


def _param_gaps(qual: str, j_fn, t_fn, used: set) -> list[str]:
    """The parameters of j_fn that t_fn lacks, or has of another kind or
    at another index."""
    try:
        j_sig, t_sig = inspect.signature(j_fn), inspect.signature(t_fn)
    except (TypeError, ValueError):  # builtins (an exception's __init__)
        return []
    t_params = [q for q in t_sig.parameters.values() if q.name != "device"]
    if len(t_params) < len(t_sig.parameters):
        used.add("device")
    method = qual.rpartition(".")[2]
    out = []
    dropped = False
    for i, p in enumerate(j_sig.parameters.values()):
        if f"{qual}({p.name})" in EXCEPTIONS:
            used.add(f"{qual}({p.name})")
            dropped = dropped or p.kind in POSITIONAL
            continue
        name = p.name if p.name in t_sig.parameters else None
        for scope in (qual, method, ""):
            new = RENAMES.get((scope, p.name))
            if name is None and new is not None and new in t_sig.parameters:
                used.add(f"{scope}: {p.name}->{new}" if scope
                         else f"{p.name}->{new}")
                name = new
        if name is None:
            out.append(f"{qual}({p.name})")
            continue
        t_p = t_sig.parameters[name]
        if name == "device":
            continue
        if p.kind in POSITIONAL and dropped:
            ok = t_p.kind == inspect.Parameter.KEYWORD_ONLY
        elif p.kind in POSITIONAL or p.kind == p.VAR_POSITIONAL:
            ok = t_p.kind == p.kind and i < len(t_params) \
                and t_params[i].name == name
        elif p.kind == p.KEYWORD_ONLY:
            ok = t_p.kind in (p.KEYWORD_ONLY, p.POSITIONAL_OR_KEYWORD)
        else:
            ok = t_p.kind == p.kind
        if not ok:
            out.append(f"{qual}({p.name}): {t_p.kind.description} "
                       f"at {t_params.index(t_p)}, JAX has "
                       f"{p.kind.description} at {i}")
    return out


@functools.lru_cache(maxsize=None)
def _left_out_index(key: str) -> int | None:
    """The index among a call's positional arguments that reaches the
    left-out parameter ``key`` names (None: keyword-only), read from the
    JAX signature."""
    qual, _, param = key[:-1].partition("(")
    top, _, method = qual.partition(".")
    for name in JAX_MODULES:
        obj = getattr(importlib.import_module(name), top, None)
        if obj is not None and method:
            obj = getattr(obj, method, None)
        if obj is None:
            continue
        params = list(inspect.signature(obj).parameters.values())
        if method and params and params[0].name == "self":
            params = params[1:]
        p = next(q for q in params if q.name == param)
        return params.index(p) if p.kind in POSITIONAL else None
    raise LookupError(key)


def _calls_in(node, fn: str, where: str, out: list) -> None:
    for child in ast.iter_child_nodes(node):
        if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
            _calls_in(child, child.name, where, out)
            continue
        if isinstance(child, ast.Call):
            out.append((f"{where}:{child.lineno}", child, fn))
        _calls_in(child, fn, where, out)


@functools.lru_cache(maxsize=None)
def _calls() -> tuple[tuple[str, ast.Call, str], ...]:
    """Every call in the JAX package, its tools, examples and bench.py:
    (file:line, call, name of the function it stands in)."""
    out = []
    for tree in CALLER_TREES:
        root = ROOT / tree
        for path in sorted(root.rglob("*.py")) if root.is_dir() else [root]:
            _calls_in(ast.parse(path.read_text()), "",
                      str(path.relative_to(ROOT)), out)
    return tuple(out)


def _is_left_out(fn: str, param: str) -> bool:
    return any(k[:-1].rpartition("(")[0].rpartition(".")[2] == fn
               and k[:-1].rpartition("(")[2] == param for k in LEFT_OUT)


@functools.lru_cache(maxsize=None)
def _gaps(name: str) -> tuple[dict, frozenset]:
    """{"module"|"names"|"methods"|"params": [gaps]} of one JAX module, and
    the exceptions that it needed."""
    gaps = {"module": [], "names": [], "methods": [], "params": []}
    used = set()
    if name in EXCEPTIONS:
        return gaps, frozenset({name})
    j_mod = importlib.import_module(name)
    try:
        t_mod = importlib.import_module(_port_name(name))
    except ImportError as e:
        gaps["module"].append(f"{_port_name(name)}: {e}")
        return gaps, frozenset()
    for key, j_obj in _public(j_mod).items():
        if not hasattr(t_mod, key):
            if key in EXCEPTIONS:
                used.add(key)
            else:
                gaps["names"].append(key)
            continue
        t_obj = getattr(t_mod, key)
        if inspect.isclass(j_obj):
            gaps["params"] += _param_gaps(key, j_obj, t_obj, used)
            for m, j_m in inspect.getmembers(j_obj):
                if m.startswith("_"):
                    continue
                if not hasattr(t_obj, m):
                    gaps["methods"].append(f"{key}.{m}")
                elif callable(j_m):
                    gaps["params"] += _param_gaps(
                        f"{key}.{m}", j_m, getattr(t_obj, m), used)
        elif callable(j_obj):
            gaps["params"] += _param_gaps(key, j_obj, t_obj, used)
    return gaps, frozenset(used)


@pytest.mark.parametrize("name", JAX_MODULES)
def test_module_has_counterpart(name):
    assert _gaps(name)[0]["module"] == []


@pytest.mark.parametrize("name", JAX_MODULES)
def test_public_names(name):
    """Every public top-level name (a package's exports) is in the port."""
    assert _gaps(name)[0]["names"] == [], _port_name(name)


@pytest.mark.parametrize("name", JAX_MODULES)
def test_class_methods(name):
    """Every public method of every class, inherited ones included."""
    assert _gaps(name)[0]["methods"] == [], _port_name(name)


@pytest.mark.parametrize("name", JAX_MODULES)
def test_parameters(name):
    """Every parameter of every public function, constructor and method,
    or its rename in EXCEPTIONS, of JAX's kind and at JAX's index."""
    assert _gaps(name)[0]["params"] == [], _port_name(name)


def test_every_exception_is_needed():
    used = set().union(*(_gaps(name)[1] for name in JAX_MODULES))
    assert set(EXCEPTIONS) - used == set()


@pytest.mark.parametrize("key", sorted(LEFT_OUT))
def test_left_out_parameter_has_no_caller(key):
    """No call in the JAX package, tools/, examples/ or bench.py passes a
    parameter that the port leaves out: not by keyword, not at its
    position, not through *args or **kwargs.  Calls are matched by the
    function's (or method's) name alone, so any call of that name
    counts; one that only hands on a left-out parameter of the function
    it stands in (fft2_step's variant to fft2_transform) does not."""
    qual, _, param = key[:-1].partition("(")
    fn = qual.rpartition(".")[2]
    index = _left_out_index(key)
    callers = []
    for where, call, outer in _calls():
        f = call.func
        if (f.id if isinstance(f, ast.Name) else
                f.attr if isinstance(f, ast.Attribute) else None) != fn:
            continue
        passed = [k.value for k in call.keywords if k.arg == param]
        if index is not None and len(call.args) > index:
            passed.append(call.args[index])
        if any(k.arg is None for k in call.keywords) \
                or any(isinstance(a, ast.Starred) for a in call.args) \
                or any(not (isinstance(v, ast.Name)
                            and _is_left_out(outer, v.id)) for v in passed):
            callers.append(where)
    assert callers == []
