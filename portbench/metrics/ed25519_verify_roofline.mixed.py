"""ed25519_verify_roofline.mixed: the share of the card's peak multiply-add
rate that the ed25519_verify kernel reaches in the profiled slice: the
frozen work of a signature times the live rows it verified, over its
device time."""
from portbench import stats


def read(rec):
    return stats.slice_roofline(rec.profile, "ed25519_verify")
