"""sr25519_challenges_ms.mixed: the challenges stage of a call's sr25519
group (its `batch.challenges` span: the merlin transcripts of the native
host packer and k mod L, ops/sr25519_kernel.py `challenge_scalars`), the
mean over the window's calls."""
from portbench import stats


def read(rec):
    return stats.mean(rec.layer.get("sr25519_challenges_ms", []))
