"""The port's host frontend (parser, binder, HEP optimizer, physical planner,
EXPLAIN rendering) against the JAX package's checked-in plan goldens:
sqlrs_tpu_torch must render every plan in tests/plan_goldens.GOLDEN_QUERIES
exactly as tests/goldens/plans.snapshot records it for sqlrs_tpu. Then the
JAX package's own frontend tests, run against the port."""

import builtins
import importlib
import types

import pytest

import sqlrs_tpu
import sqlrs_tpu_torch
from tests import plan_goldens, test_binder, test_optimizer, test_parser, test_types


def _snapshot_sections() -> dict[str, str]:
    with open(plan_goldens.SNAPSHOT) as f:
        text = f.read()
    sections = {}
    for part in text.split("==== ")[1:]:
        name, _, body = part.partition("\n")
        sections[name] = body.rstrip()
    return sections


@pytest.fixture(scope="module")
def port_db():
    db = sqlrs_tpu_torch.Database(device="cpu")
    db.run("create table t1(a int, b int, c int)")
    db.run("create table t2(a int, b int, c int)")
    return db


@pytest.mark.parametrize(
    "name,sql", plan_goldens.GOLDEN_QUERIES, ids=[n for n, _ in plan_goldens.GOLDEN_QUERIES]
)
def test_port_plan_matches_golden(port_db, name, sql):
    want = _snapshot_sections()[name]
    got = f"-- {sql}\n{port_db.explain(sql).rstrip()}"
    assert got == want


# ---- the JAX package's frontend tests, re-pointed at the port ---------------
#
# The parser, binder and optimizer are host code the port copies. Their
# tests (tests/test_{parser,binder,optimizer}.py and the type-lattice tests
# of tests/test_types.py) run here unchanged against the port: each test
# function, the module's helpers and its `db` fixture are rebuilt over a
# copy of their module's globals in which every object of the JAX package
# is its port counterpart (same module path, same name), `sqlrs_tpu` is the
# port with Database(device="cpu") as its default, and imports inside a
# function body resolve the same way. The JAX test modules are not changed.

REF, PORT = "sqlrs_tpu", "sqlrs_tpu_torch"


class _CpuDatabase(sqlrs_tpu_torch.Database):
    def __init__(self, *args, device="cpu", **kw):
        super().__init__(*args, device=device, **kw)


_PORT_ROOT = types.ModuleType(REF)
_PORT_ROOT.__dict__.update({k: v for k, v in vars(sqlrs_tpu_torch).items()
                            if not k.startswith("__")})
_PORT_ROOT.Database = _CpuDatabase
_REPOINTED: dict[str, types.ModuleType] = {}


def _port_name(name: str) -> str:
    return PORT + name[len(REF):]


def _counterpart(obj):
    """The port's object for one of the JAX package's, else obj itself."""
    if obj is sqlrs_tpu:
        return _PORT_ROOT
    if isinstance(obj, types.ModuleType):
        if obj.__name__.startswith(REF + "."):
            return importlib.import_module(_port_name(obj.__name__))
        return obj
    mod = getattr(obj, "__module__", None) or ""
    if mod.startswith(REF + ".") and hasattr(obj, "__qualname__"):
        target = importlib.import_module(_port_name(mod))
        for part in obj.__qualname__.split("."):
            target = getattr(target, part)
        return target
    return obj


def _import(name, globals=None, locals=None, fromlist=(), level=0):
    """__import__ for the re-pointed code: the JAX package's modules are
    the port's, and this repository's test helpers are re-pointed too."""
    if level == 0 and (name == REF or name.startswith(REF + ".")):
        if name == REF or not fromlist:
            builtins.__import__(_port_name(name), globals, locals, fromlist, level)
            return _PORT_ROOT
        return builtins.__import__(_port_name(name), globals, locals, fromlist, level)
    if level == 0 and name == "tests" and fromlist:
        pkg = types.SimpleNamespace()
        for sub in fromlist:
            setattr(pkg, sub, repoint_module(importlib.import_module(f"tests.{sub}")))
        return pkg
    return builtins.__import__(name, globals, locals, fromlist, level)


def _clone(fn, g: dict):
    return types.FunctionType(fn.__code__, g, fn.__name__, fn.__defaults__, fn.__closure__)


def repoint_module(mod) -> types.ModuleType:
    """A copy of `mod` whose functions run against the port."""
    if mod.__name__ in _REPOINTED:
        return _REPOINTED[mod.__name__]
    new = types.ModuleType(mod.__name__ + "[port]")
    _REPOINTED[mod.__name__] = new
    g = new.__dict__
    bt = dict(vars(builtins))
    bt["__import__"] = _import
    for k, v in vars(mod).items():
        if isinstance(v, types.FunctionType) and v.__module__ == mod.__name__:
            v = _clone(v, g)
        elif type(v).__name__ == "FixtureFunctionDefinition":
            v = _clone(v._get_wrapped_function(), g)
        else:
            v = _counterpart(v)
        g[k] = v
    g["__builtins__"] = bt
    return new


def _frontend_tests():
    """(id, module, class name or None, test name), in file order."""
    out = []
    for mod in (test_parser, test_binder, test_optimizer):
        for name, obj in vars(mod).items():
            if name.startswith("test_") and isinstance(obj, types.FunctionType):
                out.append((mod, None, name))
            elif name.startswith("Test") and isinstance(obj, type):
                out += [(mod, name, m) for m in vars(obj) if m.startswith("test_")]
    for name in ("test_max_logical_type_numeric_widening",
                 "test_max_logical_type_null_casts_to_anything",
                 "test_max_logical_type_signed_unsigned_upcast",
                 "test_max_logical_type_incomparable_raises",
                 "test_implicit_cast_rules", "test_civil_date_roundtrip"):
        out.append((test_types, None, name))
    # reads the upstream sqlrs project's tests/csv/ files, which are not part
    # of this repository
    out = [t for t in out if t[2] != "test_cp5_prune_across_multiple_joins"]
    return [(f"{m.__name__.split('.')[-1]}.py::{c + '::' if c else ''}{n}", m, c, n)
            for m, c, n in out]


FRONTEND_TESTS = _frontend_tests()


@pytest.mark.parametrize("mod,cls,name", [t[1:] for t in FRONTEND_TESTS],
                         ids=[t[0] for t in FRONTEND_TESTS])
def test_reference_frontend_test_on_port(mod, cls, name):
    port = repoint_module(mod)
    fn = vars(getattr(mod, cls))[name] if cls else getattr(mod, name)
    fn = _clone(fn, vars(port))
    args = []
    if cls:
        args.append(getattr(mod, cls)())
    if "db" in fn.__code__.co_varnames[: fn.__code__.co_argcount]:
        args.append(port.db())
    fn(*args)


def test_repointed_modules_hold_nothing_of_the_jax_package():
    """Every global of a re-pointed test module is the port's, so the tests
    above cannot reach the JAX package (and they are all there: 23 + 14 +
    41 + 6, test_cp5 left out)."""
    for mod in (test_parser, test_binder, test_optimizer, test_types):
        for k, v in vars(repoint_module(mod)).items():
            name = v.__name__ if isinstance(v, types.ModuleType) else getattr(v, "__module__", "")
            assert not (name or "").startswith(REF + "."), (mod.__name__, k, name)
            assert v is not sqlrs_tpu, (mod.__name__, k)
    assert len(FRONTEND_TESTS) == 23 + 14 + 41 + 6
