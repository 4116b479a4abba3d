"""The file-backed validator signer (the port's copy of the JAX package's
privval/file_pv.py; the remote signer comes with the network slice)."""
