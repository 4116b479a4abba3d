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


def load(name: str, subs=()) -> types.ModuleType:
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


def run(mod, name: str, request, plane: bool = True) -> None:
    """`plane=False` runs the test with no plane mounted, for a test
    whose nodes verify on the host by themselves (port_host_simnet)."""
    fn = getattr(mod, name)
    fixtures = _fixtures(mod)
    with contextlib.ExitStack() as stack:
        if plane:
            stack.enter_context(host_plane())
        for k, (_, marker) in fixtures.items():
            if marker.autouse:
                _call_fixture(mod, k, request, stack, fixtures)
        kwargs = {a: _resolve(mod, a, request, stack, fixtures)
                  for a in inspect.signature(fn).parameters}
        fn(**kwargs)


def cases(mod, names):
    """pytest params (module, test name), one a test of `mod`."""
    import pytest

    return [pytest.param(mod, n, id=f"port-{n}") for n in names]


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
