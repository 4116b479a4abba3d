"""The benchmark's plain reference: ed25519 verification, CometBFT's
canonical vote sign-bytes, and the verdict rules of the three paths the
cells drive. Plain Python; it imports nothing of the program under test.
"""
