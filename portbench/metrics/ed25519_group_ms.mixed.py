"""ed25519_group_ms.mixed: a call's ed25519 group in crypto/batch.py
`verify_batch_direct` (its `batch.group` span: the pack, upload, launch
and wait of ops/ed25519_fused.py `verify_batch`), the mean over the
window's calls."""
from portbench import stats


def read(rec):
    return stats.mean(rec.layer.get("ed25519_group_ms", []))
