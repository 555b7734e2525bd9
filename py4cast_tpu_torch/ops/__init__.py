"""Lattice primitives and the hand-written CUDA kernels with their plain
PyTorch versions. Importing this package builds nothing."""
