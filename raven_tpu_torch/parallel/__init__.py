"""The multi-device and multi-process paths: device meshes (mesh.py), the
process group and its collectives on torch.distributed (distributed.py),
the hash-range-sharded minimizer index and the sharded candidate step
(sharded_index.py), and one rank of a multi-process run (worker.py)."""
