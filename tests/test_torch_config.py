"""The port's config/config.py against the JAX package's.

The same TOML through both packages' load_config gives equal sections
(dataclasses.asdict), both render the same file, and each loads the
other's; every invalid config of the JAX package's tests
(tests/test_controller.py:385 and :427, tests/test_tracing.py:116,
tests/test_failpoints.py:131) and of validate_basic's other checks gives
the same ConfigError text. The builders give the port's objects with the
JAX knob values: VerifyPlaneConfig.build the port's VerifyPlane (its
queue, lane, mesh and flight-deck knobs equal to the JAX plane's from
the same section), build_warmer its TableWarmer, ControllerConfig its
Controller with equal bounds, MempoolConfig its AdmissionController, and
the tracing, incidents, failpoints and table-cache sections configure
the port's modules. `[crypto] verifier = "cpu"` gives the explicit host
batch_fn (the JAX package's None would be the card to the port's
executor): a node built with it commits blocks without resolving a
device, launching a kernel or creating a CUDA context."""
import dataclasses
import importlib

import numpy as np
import pytest
import torch

from cometbft_tpu.config import config as jcfg
from cometbft_tpu_torch.config import config as pcfg

PACKAGES = (jcfg, pcfg)

TOML = """
[base]
chain_id = "cfg-chain"
moniker = "m1"

[mempool]
size = 77
admission = true
high_watermark = 0.8
low_watermark = 0.5

[consensus]
timeout_propose = 0.4
timeout_propose_delta = 0.1
timeout_prevote = 0.2
timeout_commit = 0.01

[crypto]
verifier = "cpu"
breaker_failure_threshold = 3
table_cache_tables = 6

[verify_plane]
enable = true
window_ms = 2.5
max_batch = 512
max_queue = 4096
bulk_window_ms = 9.0
bulk_deadline_ms = 300.0
gateway_max_queue = 100
mesh = true
mesh_devices = 4
mesh_min_rows = 64
pipeline_flights = 2
pipeline_flights_max = 3
half_mesh_rows = 1024
warm_next_epoch = false

[lightgate]
enable = true
cache_size = 99

[controller]
enable = true
slo_commit_p99_ms = 321.0

[tracing]
buffer = 64

[incidents]
round_limit = 6

[failpoints]
spec = "wal.pre_fsync=delay:0.001*1"
"""


def _write(tmp_path, text, name="config.toml"):
    path = tmp_path / name
    path.write_text(text)
    return str(path)


def test_same_toml_gives_equal_sections_and_files(tmp_path):
    path = _write(tmp_path, TOML)
    j, p = jcfg.load_config(path), pcfg.load_config(path)
    assert dataclasses.asdict(p) == dataclasses.asdict(j)
    assert pcfg._render(p) == jcfg._render(j)
    # each package loads the other's saved file
    jcfg.save_config(j, str(tmp_path / "j.toml"))
    pcfg.save_config(p, str(tmp_path / "p.toml"))
    assert dataclasses.asdict(pcfg.load_config(str(tmp_path / "j.toml"))) \
        == dataclasses.asdict(jcfg.load_config(str(tmp_path / "p.toml"))) \
        == dataclasses.asdict(p)
    assert dataclasses.asdict(pcfg.Config()) == dataclasses.asdict(
        jcfg.Config())


def _raised(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the outcome under comparison
        return (type(e).__name__, str(e))
    return None


INVALID = {
    # tests/test_controller.py:385
    "controller_deadline_floor": lambda c: setattr(
        c.controller, "bulk_deadline_min_ms", 0.1),
    "controller_fill_order": lambda c: setattr(c.controller, "fill_low", 0.9),
    "controller_admission_floor": lambda c: setattr(
        c.controller, "admission_floor", 0.99),
    # tests/test_controller.py:427
    "flights_max_below_flights": lambda c: (
        setattr(c.verify_plane, "pipeline_flights", 2),
        setattr(c.verify_plane, "pipeline_flights_max", 1)),
    # tests/test_tracing.py:116
    "tracing_buffer": lambda c: setattr(c.tracing, "buffer", 1),
    # tests/test_failpoints.py:131
    "failpoints_action": lambda c: setattr(c.failpoints, "spec",
                                           "wal.pre_fsync=explode"),
    # validate_basic's other checks
    "chain_id": lambda c: setattr(c.base, "chain_id", ""),
    "verifier": lambda c: setattr(c.crypto, "verifier", "gpu"),
    "breaker_threshold": lambda c: setattr(
        c.crypto, "breaker_failure_threshold", 0),
    "breaker_cooldown": lambda c: setattr(c.crypto, "breaker_cooldown", -1),
    "table_cache": lambda c: setattr(c.crypto, "table_cache_tables", 1),
    "shard_tables_with_deck": lambda c: (
        setattr(c.verify_plane, "pipeline_flights", 2),
        setattr(c.crypto, "table_cache_shard_tables", 3)),
    "flights_max_negative": lambda c: setattr(
        c.verify_plane, "pipeline_flights_max", -1),
    "window": lambda c: setattr(c.verify_plane, "window_ms", -1),
    "max_batch": lambda c: setattr(c.verify_plane, "max_batch", 0),
    "max_queue": lambda c: setattr(c.verify_plane, "max_queue", 10),
    "lane_knob": lambda c: setattr(c.verify_plane, "bulk_max_queue", -2),
    "mesh_one": lambda c: setattr(c.verify_plane, "mesh_devices", 1),
    "flights_zero": lambda c: setattr(c.verify_plane, "pipeline_flights", 0),
    "lightgate": lambda c: setattr(c.lightgate, "trusting_period", 0),
    "mempool_size": lambda c: setattr(c.mempool, "size", 0),
    "mempool_watermarks": lambda c: setattr(c.mempool, "low_watermark", 0.95),
    "controller_slo": lambda c: setattr(c.controller, "slo_bulk_wait_ms", 0),
    "controller_window_step": lambda c: setattr(
        c.controller, "window_step", 1.0),
    "incidents": lambda c: setattr(c.incidents, "round_limit", 0),
    "incidents_window": lambda c: setattr(c.incidents, "window_s", -1),
    "consensus_timeout": lambda c: setattr(
        c.consensus, "timeout_commit", -0.5),
    "failpoints_syntax": lambda c: setattr(c.failpoints, "spec", "nonsense"),
}


@pytest.mark.parametrize("name", sorted(INVALID))
def test_invalid_configs_give_the_jax_error_text(name):
    outs = []
    for mod in PACKAGES:
        cfg = mod.Config()
        INVALID[name](cfg)
        outs.append(_raised(cfg.validate_basic))
    assert outs[0] is not None and outs[0][0] == "ConfigError"
    assert outs[1] == outs[0]


def test_unknown_key_and_load_errors_equal(tmp_path):
    path = _write(tmp_path, "[mempool]\nsize = 5\nbogus = 1\n")
    assert _raised(lambda: pcfg.load_config(path)) == \
        _raised(lambda: jcfg.load_config(path)) == \
        ("ConfigError", "unknown key [mempool] bogus")
    path = _write(tmp_path, "[crypto]\nverifier = \"gpu\"\n", "v.toml")
    assert _raised(lambda: pcfg.load_config(path)) == \
        _raised(lambda: jcfg.load_config(path))


PLANE_KNOBS = ("window", "max_batch", "max_queue", "bulk_window",
               "bulk_max_queue", "bulk_deadline", "gateway_window",
               "gateway_max_queue", "gateway_deadline", "_mesh_devices",
               "mesh_min_rows", "flights", "flights_max", "half_mesh_rows")


def test_verify_plane_config_builds_the_ports_plane(tmp_path):
    from cometbft_tpu.verifyplane import VerifyPlane as JPlane
    from cometbft_tpu_torch.libs.metrics import NodeMetrics
    from cometbft_tpu_torch.verifyplane import VerifyPlane as PPlane
    from cometbft_tpu_torch.verifyplane.warmer import TableWarmer

    path = _write(tmp_path, TOML)
    j, p = jcfg.load_config(path), pcfg.load_config(path)
    jplane = j.verify_plane.build()
    m = NodeMetrics()
    pplane = p.verify_plane.build(metrics=m, device="cpu")
    assert isinstance(jplane, JPlane) and isinstance(pplane, PPlane)
    assert {k: getattr(pplane, k) for k in PLANE_KNOBS} == \
        {k: getattr(jplane, k) for k in PLANE_KNOBS}
    assert pplane.device == torch.device("cpu") and pplane.metrics is m
    assert p.verify_plane.build_warmer(device="cpu") is None  # knob off
    p.verify_plane.warm_next_epoch = True
    w = p.verify_plane.build_warmer(device="cpu")
    assert isinstance(w, TableWarmer) and w.device == torch.device("cpu")
    p.verify_plane.enable = False
    assert p.verify_plane.build() is None
    assert p.verify_plane.build_warmer() is None


def test_other_builders_give_the_ports_objects(tmp_path):
    from cometbft_tpu_torch.libs import controller as pctl
    from cometbft_tpu_torch.libs import failpoints as pfp
    from cometbft_tpu_torch.libs import incidents as pinc
    from cometbft_tpu_torch.libs import tracing as ptracing
    from cometbft_tpu_torch.mempool.admission import AdmissionController
    from cometbft_tpu_torch.ops import table_cache as ptc
    from cometbft_tpu.libs import failpoints as jfp
    from cometbft_tpu.ops import table_cache as jtc

    path = _write(tmp_path, TOML)
    j, p = jcfg.load_config(path), pcfg.load_config(path)
    jctl, pctl_obj = j.controller.build(), p.controller.build()
    assert isinstance(pctl_obj, pctl.Controller)
    assert p.controller.bounds(p.verify_plane, p.mempool) == \
        j.controller.bounds(j.verify_plane, j.mempool)
    assert vars(pctl_obj).keys() >= {"slo_commit_p99_ms"} and \
        pctl_obj.slo_commit_p99_ms == jctl.slo_commit_p99_ms == 321.0
    adm = p.mempool.build_admission(fill_fn=lambda: 0.0)
    assert isinstance(adm, AdmissionController)
    p.mempool.admission = False
    assert p.mempool.build_admission() is None
    caps = (jtc.capacities(), ptc.capacities())
    rec = pinc.recorder()
    old_limit = rec.round_limit
    try:
        for c in (j, p):
            c.crypto.apply_table_cache()
        assert ptc.capacities() == jtc.capacities()
        assert ptc.capacities()["tables"] == 6
        p.incidents.apply()
        assert rec.round_limit == 6
        p.tracing.enable, p.tracing.profile_dir = True, str(tmp_path / "prof")
        p.tracing.apply()
        assert ptracing.enabled() and ptracing.tracer().capacity == 64
        assert ptracing.profile_dir() == str(tmp_path / "prof")
        p.tracing.enable = False
        p.tracing.apply()
        assert not ptracing.enabled()
        p.failpoints.apply()
        assert pfp.registry().stats("wal.pre_fsync")["action"] == "delay"
        st = jfp.registry().stats("wal.pre_fsync")
        assert st is None or st["action"] == ""
    finally:
        pfp.reset()
        ptracing.set_profile_dir("")
        rec.round_limit = old_limit
        for mod, c in ((jtc, caps[0]), (ptc, caps[1])):
            mod.set_capacities(tables=c["tables"],
                               shard_tables=c["shard_tables"],
                               key_memo=c["key_memo"],
                               valset_memo=c["valset_memo"],
                               templates=c["templates"])


def _rows(n, bad=()):
    from cometbft_tpu_torch.crypto.keys import PrivKey

    privs = [PrivKey.generate(bytes([i + 9]) * 32) for i in range(n)]
    msgs = [b"msg-%d" % i for i in range(n)]
    sigs = [p.sign(m) for p, m in zip(privs, msgs)]
    sigs = [s[:5] + bytes([s[5] ^ 1]) + s[6:] if i in bad else s
            for i, s in enumerate(sigs)]
    return [p.pub_key() for p in privs], msgs, sigs


def test_cpu_verifier_is_an_explicit_host_batch_fn(monkeypatch):
    """The JAX package's verifier = "cpu" batch_fn is None; the port's is
    a host callable (None would be the card to the port's executor)."""
    from cometbft_tpu_torch.crypto import batch as pbatch

    calls = []
    monkeypatch.setattr(pbatch, "verify_batch_direct",
                        lambda *a, **k: calls.append(a))
    c = pcfg.Config()
    c.crypto.verifier = "cpu"
    jc = jcfg.Config()
    jc.crypto.verifier = "cpu"
    assert jc.crypto.batch_fn() is None
    fn = c.crypto.batch_fn()
    assert fn is not None and fn.on_host
    pubs, msgs, sigs = _rows(4, bad={2})
    assert np.asarray(fn(pubs, msgs, sigs)).tolist() == [True, True, False,
                                                         True]
    assert calls == []
    # "tpu" rides the running plane's CONSENSUS lane (else the device it
    # is given, the card by default)
    from cometbft_tpu_torch.verifyplane import (VerifyPlane,
                                                set_global_plane)

    c.crypto.verifier = "tpu"
    tfn = c.crypto.batch_fn(device="cpu")
    assert not getattr(tfn, "on_host", False)
    plane = VerifyPlane(use_device=False)
    plane.start()
    set_global_plane(plane)
    try:
        assert np.asarray(tfn(pubs, msgs, sigs)).tolist() == [
            True, True, False, True]
    finally:
        set_global_plane(None)
        plane.stop()
    assert plane.stats()["lane_rows"]["consensus"] == 4 and calls == []


def test_cpu_verifier_node_launches_nothing(tmp_path, monkeypatch):
    """A node built as the CLI builds one from `verifier = "cpu"` (no
    device argument: any other node would resolve the card and raise here)
    commits heights with every signature on the host: no
    verify_batch_direct call, no kernel wrapper call, no CUDA context."""
    from cometbft_tpu_torch.abci.kvstore import KVStoreApplication
    from cometbft_tpu_torch.consensus.ticker import TimeoutParams
    from cometbft_tpu_torch.crypto import batch as pbatch
    from cometbft_tpu_torch.crypto.keys import PrivKey
    from cometbft_tpu_torch.node.node import Node
    from cometbft_tpu_torch.privval.file_pv import FilePV
    from cometbft_tpu_torch.state.state import State
    from cometbft_tpu_torch.types.validator import Validator, ValidatorSet

    touched = []
    monkeypatch.setattr(pbatch, "verify_batch_direct",
                        lambda *a, **k: touched.append("direct"))
    for mod, names in (("ops.ed25519_fused", ("verify_rows",
                                              "ed25519_verify")),
                       ("ops.ed25519_cached", ("ed25519_verify_cached",
                                               "valset_table_build")),
                       ("ops.ed25519_stamp", ("stamp_rows",))):
        m = importlib.import_module(f"cometbft_tpu_torch.{mod}")
        for n in names:
            monkeypatch.setattr(m, n, lambda *a, _n=n, **k:
                                touched.append(_n))
    cuda_before = torch.cuda.is_initialized()
    cfg = pcfg.load_config(_write(tmp_path, TOML))
    assert cfg.crypto.verifier == "cpu"
    privs = [PrivKey.generate(bytes([i + 61]) * 32) for i in range(2)]
    vals = ValidatorSet([Validator(p.pub_key(), 10) for p in privs])
    state = State.make_genesis(cfg.base.chain_id, vals)
    from cometbft_tpu_torch.node.node import LocalNetwork

    net = LocalNetwork()
    for i, priv in enumerate(privs):
        net.add(Node(KVStoreApplication(), state.copy(),
                     privval=FilePV(priv), home=str(tmp_path / f"n{i}"),
                     broadcast=net.broadcaster(i),
                     timeouts=TimeoutParams(
                         propose=0.4, propose_delta=0.1, prevote=0.2,
                         prevote_delta=0.1, precommit=0.2,
                         precommit_delta=0.1, commit=0.01),
                     batch_fn=cfg.crypto.batch_fn(),
                     mempool_config=cfg.mempool))
    assert all(n.on_host and n.device is None for n in net.nodes)
    for n in net.nodes:
        n.start()
    try:
        net.nodes[0].broadcast_tx(b"cpu=node")
        for n in net.nodes:
            assert n.consensus.wait_for_height(3, timeout=60), n.height()
        assert net.nodes[1].query(b"cpu").value == b"node"
    finally:
        for n in reversed(net.nodes):
            n.stop()
    assert touched == []
    assert torch.cuda.is_initialized() == cuda_before
