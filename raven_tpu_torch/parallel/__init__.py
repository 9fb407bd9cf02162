"""The single-host multi-device path: device meshes (mesh.py) and the
hash-range-sharded minimizer index (sharded_index.py)."""
