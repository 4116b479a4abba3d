"""Runs a JAX package test module's scenarios on the port.

`load(name)` executes tests/<name> as a fresh module whose imports of the
JAX package point at `cometbft_tpu_torch`: the same test bodies, the same
assertions and bounds, on the port's modules. The JAX package's own run
of each module is tests/<name> itself. `subs` are exact textual edits
(each must occur), for the few places where the port is built
differently: a node or a simnet on `device="cpu"` (`port_node`,
`port_simnet`, swapped in for every plain import of `Node` or
`Simnet`), a StreamVerifier on the CPU's
plain kernels, a wait on a condition in place of a fixed sleep.
`run(mod, name, request)` calls one test of such a module with its
fixtures: pytest's own (tmp_path, monkeypatch, ...) through `request`,
the module's own fixtures (module scope cached per module, generator
fixtures finalised), its autouse fixtures around the call. Each run rides
a host verify plane (VerifyPlane(use_device=False), the JAX semantics:
every signature on the host) registered as the global plane, so the
port's nodes, executors, mempools and evidence pools take no plain-kernel
path by default (a plain cached verify on one core costs seconds a
flush)."""
from __future__ import annotations

import contextlib
import inspect
import re
import sys
import types
from pathlib import Path

TESTS = Path(__file__).resolve().parent
_JAX_NAME = re.compile(r"\bcometbft_tpu\b")


# a function-level import of LocalNetwork and Node, Node made the port's
# on the CPU
LOCAL_NET_NODE = (
    "    from cometbft_tpu_torch.node.node import LocalNetwork, Node\n",
    "    from cometbft_tpu_torch.node.node import LocalNetwork\n"
    "    from torch_mirror import port_node as Node\n")


def port_node(*args, **kw):
    """The port's Node on the CPU (its default, the card, raises here)."""
    from cometbft_tpu_torch.node.node import Node

    kw.setdefault("device", "cpu")
    return Node(*args, **kw)


def port_simnet(*args, **kw):
    """The port's Simnet on the CPU: every node it builds gets
    device="cpu" (its default, the card, raises here)."""
    from cometbft_tpu_torch.simnet import Simnet

    kw.setdefault("device", "cpu")
    return Simnet(*args, **kw)


def port_host_simnet(*args, **kw):
    """The port's Simnet of host nodes (batch_fn=oracle_batch_fn()).
    Run with no plane mounted (run(..., plane=False)), every signature
    verifies inline on the scheduler thread, as the JAX Simnet's nodes
    verify when no plane runs: no flush of a plane shared by a test's
    two runs enters the trace or incident snapshots they compare byte
    for byte."""
    from cometbft_tpu_torch.simnet import Simnet
    from cometbft_tpu_torch.types.validation import oracle_batch_fn

    kw.setdefault("batch_fn", oracle_batch_fn())
    return Simnet(*args, **kw)


# the port simnet a test imports by name, made host nodes
HOST_SIMNET = ("    from torch_mirror import port_simnet as Simnet\n",
               "    from torch_mirror import port_host_simnet as Simnet\n")


def _close_paren(src: str, i: int) -> int:
    """Index of the parenthesis closing the one at src[i]; quotes are
    skipped (no escapes inside the calls this rewrites)."""
    depth, quote = 0, None
    for j in range(i, len(src)):
        c = src[j]
        if quote:
            quote = None if c == quote else quote
        elif c in "'\"":
            quote = c
        elif c in "([{":
            depth += 1
        elif c in ")]}":
            depth -= 1
            if depth == 0:
                return j
    raise ValueError("unbalanced call")


def cpu_calls(src: str, name: str) -> str:
    """Every call of `name` (a function's dotted name as the source
    spells it) in `src` with `device="cpu"` added as its last argument:
    the port's default device is the card, which raises DeviceError
    here, where the JAX call has no device. Each name must be called."""
    pat = re.compile(r"(?<![\w.])" + re.escape(name) + r"\(")
    out, pos, n = [], 0, 0
    for m in pat.finditer(src):
        if m.start() < pos:
            continue
        close = _close_paren(src, m.end() - 1)
        inner = src[m.end():close]
        stripped = inner.rstrip()
        if not stripped:
            inner = 'device="cpu"'
        elif stripped.endswith(","):
            inner = stripped + ' device="cpu"' + inner[len(stripped):]
        else:
            inner += ', device="cpu"'
        out.append(src[pos:m.end()] + inner)
        pos, n = close, n + 1
    assert n, f"no call of {name}"
    return "".join(out) + src[pos:]


def load(name: str, subs=(), cpu=()) -> types.ModuleType:
    """`cpu`: dotted function names whose every call runs on the plain
    kernels (`cpu_calls`), after `subs`."""
    path = TESTS / name
    src = _JAX_NAME.sub("cometbft_tpu_torch", path.read_text())
    src = src.replace(
        "from cometbft_tpu_torch.node.node import Node\n",
        "from torch_mirror import port_node as Node\n")
    src = src.replace(
        "from cometbft_tpu_torch.simnet import Simnet\n",
        "from torch_mirror import port_simnet as Simnet\n")
    for old, new in subs:
        assert old in src, f"{name}: no {old!r} to replace"
        src = src.replace(old, new)
    for fn in cpu:
        src = cpu_calls(src, fn)
    mod = types.ModuleType(f"mirror_port_{path.stem}")
    mod.__file__ = str(path)
    # a dataclass looks its module up by name
    sys.modules[mod.__name__] = mod
    exec(compile(src, str(path), "exec"), mod.__dict__)
    mod._fixture_cache = {}
    return mod


def _fixtures(mod):
    out = {}
    for k, v in vars(mod).items():
        fn = getattr(v, "_get_wrapped_function", None)
        if fn is not None:
            out[k] = (fn(), v._fixture_function_marker)
    return out


def _call_fixture(mod, name, request, stack, fixtures):
    fn, marker = fixtures[name]
    if marker.scope == "module" and name in mod._fixture_cache:
        return mod._fixture_cache[name]
    kwargs = {a: _resolve(mod, a, request, stack, fixtures)
              for a in inspect.signature(fn).parameters}
    val = fn(**kwargs)
    if inspect.isgenerator(val):
        gen = val
        val = next(gen)
        stack.callback(lambda: next(gen, None))
    if marker.scope == "module":
        mod._fixture_cache[name] = val
    return val


def _resolve(mod, arg, request, stack, fixtures):
    if arg in fixtures:
        return _call_fixture(mod, arg, request, stack, fixtures)
    return request.getfixturevalue(arg)


@contextlib.contextmanager
def host_plane():
    """The port's host verify plane, registered global for one test."""
    from cometbft_tpu_torch import verifyplane
    from cometbft_tpu_torch.verifyplane.plane import VerifyPlane

    plane = VerifyPlane(use_device=False)
    plane.start()
    verifyplane.set_global_plane(plane)
    try:
        yield plane
    finally:
        verifyplane.clear_global_plane(plane)
        plane.stop()


def run(mod, name: str, request, plane: bool = True,
        args: dict = None) -> None:
    """`plane=False` runs the test with no plane mounted, for a test
    whose nodes verify on the host by themselves (port_host_simnet).
    `args` are a parametrised case's arguments (`param_cases`); the
    test's other arguments are fixtures."""
    fn = getattr(mod, name)
    fixtures = _fixtures(mod)
    args = args or {}
    with contextlib.ExitStack() as stack:
        if plane:
            stack.enter_context(host_plane())
        for k, (_, marker) in fixtures.items():
            if marker.autouse:
                _call_fixture(mod, k, request, stack, fixtures)
        kwargs = {a: args[a] if a in args
                  else _resolve(mod, a, request, stack, fixtures)
                  for a in inspect.signature(fn).parameters}
        fn(**kwargs)


def cases(mod, names):
    """pytest params (module, test name), one a test of `mod`."""
    import pytest

    return [pytest.param(mod, n, id=f"port-{n}") for n in names]


def module_tests(mod) -> list:
    """Every test function of a mirror module, in source order."""
    return [k for k, v in vars(mod).items()
            if k.startswith("test_") and inspect.isfunction(v)
            and v.__module__ == mod.__name__]


# the JAX kernels' XLA route (in place of Pallas), on the port the plain
# kernels: the port has one route a kernel, on the device it is given
NO_PALLAS = ("use_pallas=False", 'device="cpu"')


DEVICE_ERROR = "from cometbft_tpu_torch.device import DeviceError\n"


EXP_CHECK = "np.testing.assert_array_equal(got, np.asarray(exp))"


def c1(call: str, before: str = "", indent: str = "    ",
       checked: bool = True) -> tuple:
    """The C1 substitution for one faulted call. Where the JAX test takes
    the host fallback's verdicts, `{indent}got = {call}` then
    `{indent}{EXP_CHECK}` (or `{indent}{call}` alone, `checked=False`),
    the port raises DeviceError: it never verifies on the host behind a
    device fault (ROADMAP C1). The call moves into
    `pytest.raises(DeviceError)`. `before`, the exact text just before
    it, picks one occurrence and stays. The mirror needs `DEVICE_ERROR`
    among its imports."""
    old = (f"{before}{indent}got = {call}\n{indent}{EXP_CHECK}\n"
           if checked else f"{before}{indent}{call}\n")
    new = (f"{before}{indent}with pytest.raises(DeviceError):\n"
           f"{indent}    {call}\n")
    return old, new


def _case_id(names, values, i) -> str:
    parts = []
    for n, v in zip(names, values):
        simple = isinstance(v, (int, str, bool)) and len(str(v)) <= 16
        parts.append(str(v) if simple else f"{n}{i}")
    return "-".join(parts)


def param_cases(mod, names):
    """pytest params (module, test name, arguments), one a case of each
    test in `names`, as pytest would run the module itself: a test's
    `pytest.mark.parametrize` marks (stacked ones multiply) give one case
    a combination of values, with its id; a test without them gives one
    case with no arguments. Run each with `run(mod, name, request,
    args=arguments)`. The JAX module's own marks (a skip, a slow mark)
    are not carried over."""
    import itertools

    import pytest

    out = []
    for name in names:
        fn = getattr(mod, name)
        axes = []
        for mark in reversed(getattr(fn, "pytestmark", [])):
            if mark.name != "parametrize":
                continue
            argnames, argvalues = mark.args[:2]
            if isinstance(argnames, str):
                argnames = [a.strip() for a in argnames.split(",")]
            rows = []
            for i, v in enumerate(argvalues):
                vals = getattr(v, "values", None)
                if vals is None:
                    vals = (v,) if len(argnames) == 1 else tuple(v)
                rows.append((dict(zip(argnames, vals)),
                             getattr(v, "id", None)
                             or _case_id(argnames, vals, i)))
            axes.append(rows)
        for combo in itertools.product(*axes):
            args = {k: v for a, _ in combo for k, v in a.items()}
            cid = "-".join(c for _, c in combo)
            out.append(pytest.param(
                mod, name, args,
                id=f"port-{name}" + (f"[{cid}]" if cid else "")))
    return out


BENCH_HELPERS = ("peer_ledger_bookkeeping_us", "height_ledger_bookkeeping_us")


def port_bench():
    """bench.py's ledger bookkeeping helpers (BENCH_HELPERS) over the
    port's ledgers: each function's own source, its imports pointed at
    the port."""
    import bench

    ns = {"_now_ms": bench._now_ms}
    for name in BENCH_HELPERS:
        src = inspect.getsource(getattr(bench, name))
        exec(compile(_JAX_NAME.sub("cometbft_tpu_torch", src),
                     bench.__file__, "exec"), ns)
    return types.SimpleNamespace(**{n: ns[n] for n in BENCH_HELPERS})


def port_tool(name: str) -> types.ModuleType:
    """tools/<name>.py (a repo script over the JAX package) as a module
    whose imports of the JAX package point at the port."""
    path = TESTS.parent / "tools" / f"{name}.py"
    mod = types.ModuleType(f"port_tool_{name}")
    mod.__file__ = str(path)
    src = _JAX_NAME.sub("cometbft_tpu_torch", path.read_text())
    exec(compile(src, str(path), "exec"), mod.__dict__)
    return mod
