"""Parallelism layout of the port (``MeshSpec``)."""
