"""The PyTorch port stands alone: it imports neither jax nor any module of
the JAX package, and it never picks the host silently."""
import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import cometbft_tpu_torch
from cometbft_tpu_torch import device

ROOT = Path(__file__).resolve().parents[1]
PKG = Path(cometbft_tpu_torch.__file__).resolve().parent
_IMPORT = re.compile(r"^\s*(?:import|from)\s+([\w.]+)", re.M)


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(PKG.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        yield ".".join(parts)


def test_importing_the_port_loads_no_jax_module():
    code = (
        "import importlib, sys\n"
        f"for m in {list(_modules())!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith('jax.') or m == 'cometbft_tpu'\n"
        "             or m.startswith('cometbft_tpu.'))\n"
        "print(','.join(bad))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", out.stdout


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) + [
    ROOT / "chip_smoke.py"], ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_nothing_of_jax_or_the_jax_package(path):
    for mod in _IMPORT.findall(path.read_text()):
        top = mod.split(".")[0]
        assert top != "jax", f"{path}: imports {mod}"
        assert top != "cometbft_tpu", f"{path}: imports {mod}"


def _strings(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            yield node.lineno, node.value


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) + [
    ROOT / "chip_smoke.py"], ids=lambda p: str(p.relative_to(ROOT)))
def test_source_names_no_jax_package_module_in_a_string(path):
    """A module looked up by name (sys.modules.get("cometbft_tpu.x"), as
    the device ledger, the incident recorder and the controller do) would
    read the JAX package's module whenever both are loaded, which the
    import checks cannot see: every dotted name in a string literal,
    docstrings included, must be the port's."""
    for line, text in _strings(path):
        assert not re.search(r"\bcometbft_tpu\.", text), (
            f"{path}:{line}: names a module of the JAX package: {text!r}")


def test_the_checks_cover_every_module_and_kernel_source():
    """The import checks above walk every module of the port, the sr25519
    and ECDSA slice's, the native host packer's and the verify plane's
    with its host libs included; every kernel
    source has a build entry, every header is in the host build the CPU
    tests check, and the native packer's C++ source includes only the C++
    standard library. They also walk the main path's entry and the light
    client: the warmer, VoteSet, the block types and light/; and the
    catch-up engine, the evidence verifiers and pool, the light-client
    gateway, the light proxy and what it imports; and the application
    boundary and block execution: abci/, mempool/, the genesis, params
    and BFT-time types, store/ and the state store and executor."""
    from cometbft_tpu_torch.ops import _build

    mods = set(_modules())
    for m in ("crypto.keccak", "crypto.merlin", "crypto.ristretto_ref",
              "crypto.sr25519_ref", "crypto.secp256k1_ref", "edge_cases",
              "ops.sr25519_kernel", "ops.secp256k1", "ops.ecdsa_kernel",
              "ops.ecdsa_fused", "native", "libs.quantiles", "libs.bits",
              "libs.tracing", "libs.failpoints", "libs.incidents",
              "libs.controller", "libs.deviceledger", "libs.staging",
              "verifyplane", "verifyplane.plane", "verifyplane.tenants",
              "verifyplane.fused", "verifyplane.warmer", "types.vote_set",
              "types.block", "types.part_set", "types.serde",
              "types.evidence", "state.state", "light", "light.verifier",
              "light.client", "light.store", "types.tx",
              "crypto.proof_ops", "rpc", "rpc.client", "evidence",
              "evidence.verify", "evidence.pool", "lightgate",
              "lightgate.cache", "lightgate.gateway", "light.proxy",
              "blocksync.catchup", "abci", "abci.types", "abci.kvstore",
              "mempool", "mempool.sigtx", "mempool.admission",
              "mempool.mempool", "types.bft_time", "types.params",
              "types.genesis", "store", "store.blockstore",
              "state.execution"):
        assert f"cometbft_tpu_torch.{m}" in mods
    csrc = PKG / "csrc"
    assert sorted(p.name for p in csrc.glob("*.cu")) == sorted(_build.KERNELS)
    host = (csrc / "ed25519_host.cpp").read_text()
    for h in csrc.glob("*.cuh"):
        assert f'#include "{h.name}"' in host, h.name
        for mod in re.findall(r'^#include\s+[<"]([\w./]+)[>"]',
                              h.read_text(), re.M):
            assert "jax" not in mod and "cometbft_tpu/" not in mod
    assert re.findall(r'^#include\s+[<"]([\w./]+)[>"]',
                      (csrc / "hostaccel.cpp").read_text(), re.M) == [
        "cstdint", "cstring"]


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(device.DeviceError, match="device='cpu'"):
        device.default_device()
    with pytest.raises(device.DeviceError):
        device.resolve(None)
    assert device.resolve("cpu") == torch.device("cpu")


def test_default_device_refuses_a_card_that_is_not_hopper(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda i=0: (8, 0))
    with pytest.raises(device.DeviceError, match="capability 8.0"):
        device.default_device()
