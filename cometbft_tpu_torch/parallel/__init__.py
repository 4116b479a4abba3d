"""Meshes of device slots and the sharded verification steps
(parallel/mesh.py)."""
