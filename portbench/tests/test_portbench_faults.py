"""`correct` at work, on tiny copies of the cells on the CPU: sound runs
come out correct; the control, and the program broken underneath the
timed path, come out not correct.

The faults, for each kind of cell: the step returns its state unchanged
(its first answer, again and again, or a tally that never moves); half
of the batch is left out (taken as valid unverified); an answer is
altered where it is produced. The cells run on one chip, so there is no
exchange between chips to leave out. Two more give the other numbers
compared a reading: sign-bytes built wrong, and a device that never
answers. Takes a few minutes: the plain
PyTorch kernels verify on one CPU core.
"""
from concurrent.futures import Future

import pytest
import torch

import _portbench_support as sup

torch.set_num_threads(1)
KINDS = {"commit": "commit10k-light", "stream": "stream1k-cached",
         "powershift": "stream1k-powershift",
         "plane": "plane10k-precommits"}


def _commit_fault(monkeypatch, fault):
    from cometbft_tpu_torch.crypto import batch

    orig = batch.verify_batch
    first = []

    def broken(pubs, msgs, sigs, **kw):
        if fault == "unchanged":
            if not first:
                first.append(orig(pubs, msgs, sigs, **kw))
            return first[0]
        if fault == "half":
            k = len(pubs) // 2
            out = list(orig(pubs[:k], msgs[:k], sigs[:k], **kw))
            return torch.tensor(out + [True] * (len(pubs) - k)).numpy()
        out = orig(pubs, msgs, sigs, **kw).copy()
        out[len(pubs) - 1] = not out[len(pubs) - 1]
        return out

    monkeypatch.setattr(batch, "verify_batch", broken)


def test_wrong_sign_bytes_are_counted(monkeypatch):
    from cometbft_tpu_torch.types.commit import Commit

    orig = Commit.sign_bytes_rows

    def rows(self, chain_id, idxs=None):
        out = orig(self, chain_id, idxs)
        return [out[0][:-1] + bytes([out[0][-1] ^ 1])] + out[1:]

    monkeypatch.setattr(Commit, "sign_bytes_rows", rows)
    out = sup.run_tiny(KINDS["commit"], seconds=2.0)
    assert out["checks"]["sign_bytes_wrong"]["value"] > 0
    assert not out["correct"]


@pytest.mark.parametrize("kind", ["commit", "stream", "powershift"])
def test_a_device_that_never_answers_is_not_correct(kind, monkeypatch):
    """Set-up warms up on a sound program; then every call faults."""
    from cometbft_tpu_torch.device import DeviceError
    from portbench import driver

    def fault(*a, **kw):
        raise DeviceError("no answer")

    orig = driver.Driver.window

    def window(self, seconds):
        if kind == "commit":
            monkeypatch.setattr(
                "cometbft_tpu_torch.crypto.batch.verify_batch", fault)
        else:
            monkeypatch.setattr(self.sv, "verify", fault)
        orig(self, seconds)

    monkeypatch.setattr(driver.Driver, "window", window)
    out = sup.run_tiny(KINDS[kind], seconds=1.0)
    assert not out["correct"] and out["failed"] == out["attempted"] > 0
    name = "calls_unanswered" if kind == "commit" else "commits_unanswered"
    assert out["checks"][name]["value"] == out["failed"]


def _stream_fault(monkeypatch, fault):
    from cometbft_tpu_torch.blocksync import pipeline
    from cometbft_tpu_torch.types.validation import NotEnoughPowerError

    cls = pipeline.StreamVerifier
    if fault == "unchanged":
        orig, first = cls.verify, []

        def verify(self, jobs):
            if not first:
                first.append(orig(self, jobs))
            return list(first[0])

        monkeypatch.setattr(cls, "verify", verify)
        return
    orig = cls._collect

    def collect(self, chunk, results):
        before = list(results)
        orig(self, chunk, results)
        gis = [gi for gi, _ in chunk.jobs]
        if fault == "half":
            for gi in gis[len(gis) // 2:]:
                results[gi] = before[gi]
        else:
            results[gis[0]] = (NotEnoughPowerError(-1, 0)
                               if results[gis[0]] is None else None)

    monkeypatch.setattr(cls, "_collect", collect)


def _plane_fault(monkeypatch, fault):
    from cometbft_tpu_torch.verifyplane import QuorumGroup, plane
    from portbench.traffic import plane as driver

    monkeypatch.setattr(driver, "RESULT_TIMEOUT_S", 3.0)
    if fault == "unchanged":
        monkeypatch.setattr(QuorumGroup, "add", lambda self, power: False)
    elif fault == "half":
        orig, n = plane.VerifyPlane.submit_many, [0]

        def submit_many(self, rows, power=0, group=None, counted=False,
                        **kw):
            n[0] += 1
            if n[0] % 2:
                return orig(self, rows, power=power, group=group,
                            counted=counted, **kw)
            if counted and group is not None:
                group.add(power)
            f = Future()
            f.set_result((True,) * len(rows))
            return f

        monkeypatch.setattr(plane.VerifyPlane, "submit_many", submit_many)
    else:
        orig, n = plane.VerifyFuture._resolve, [0]

        def resolve(self, verdicts):
            n[0] += 1
            if n[0] % 5 == 0:
                verdicts = [not v for v in verdicts]
            orig(self, verdicts)

        monkeypatch.setattr(plane.VerifyFuture, "_resolve", resolve)


FAULTS = {"commit": _commit_fault, "stream": _stream_fault,
          "powershift": _stream_fault, "plane": _plane_fault}


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_sound_runs_are_correct(kind):
    out = sup.run_tiny(KINDS[kind], seconds=2.0, trace=kind == "plane")
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_the_control_is_not_correct(kind):
    out = sup.run_tiny(KINDS[kind], seconds=3.0, control=True)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_a_broken_program_is_not_correct(kind, fault, monkeypatch):
    FAULTS[kind](monkeypatch, fault)
    out = sup.run_tiny(KINDS[kind], seconds=4.0)
    assert not out["correct"], out["checks"]
