"""sr25519_group_ms.mixed: a call's sr25519 group in crypto/batch.py
`verify_batch_direct` (its `batch.group` span: the challenges, pack,
upload, launch and wait of ops/sr25519_kernel.py `verify_batch`), the
mean over the window's calls."""
from portbench import stats


def read(rec):
    return stats.mean(rec.layer.get("sr25519_group_ms", []))
