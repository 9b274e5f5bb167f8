"""Multi-device execution of the port: the single-process mesh
(parallel/mesh.py)."""
