"""The multi-device prover: a mesh of torch devices (mesh.py)."""
