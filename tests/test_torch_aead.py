"""tests/test_aead_ref.py and tests/test_symmetric.py on the port
(tests/torch_mirror.py): X25519, ChaCha20-Poly1305 and HKDF against their
RFC vectors, XChaCha20-Poly1305's HChaCha20, and a secret connection over
whichever AEAD backend the gate loaded."""
import pytest

import torch_mirror as tm

AEAD = [
    "test_x25519_rfc7748_vectors",
    "test_chacha20poly1305_rfc8439_vector",
    "test_hkdf_rfc5869_case1",
    "test_ed25519_sign_fallback_matches_ref",
    "test_secp256k1_sign_verify_roundtrip",
    "test_secret_connection_over_fallback_or_openssl",
]
SYMMETRIC = [
    "test_hchacha20_differential_vs_openssl",
    "test_hchacha20_cfrg_vector",
    "test_seal_open_roundtrip_and_tamper",
    "test_sealed_blob_convenience",
    "test_bad_lengths",
]
PARAMS = (tm.cases(tm.load("test_aead_ref.py"), AEAD)
          + tm.cases(tm.load("test_symmetric.py"), SYMMETRIC))


@pytest.mark.parametrize("mod,name", PARAMS)
def test_aead(mod, name, request):
    tm.run(mod, name, request)
