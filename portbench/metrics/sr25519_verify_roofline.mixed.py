"""sr25519_verify_roofline.mixed: the share of the card's peak multiply-add
rate that the sr25519_verify kernel reaches in the profiled slice: the
frozen work of a signature (`frozen/opcounts_sr25519.py`) times the live
rows it verified, over its device time."""
from portbench.frozen import opcounts, opcounts_sr25519

KERNEL = "sr25519_verify"


def read(rec):
    p = rec.profile
    seconds = p.kernel_seconds(KERNEL) if p else None
    rows = p.rows.get(KERNEL, 0) if p else 0
    if not seconds or rows <= 0:
        return None
    work = opcounts_sr25519.MULADDS_PER_SIGNATURE * rows
    return 100.0 * work / opcounts.PEAK_MULADDS_PER_S / seconds
