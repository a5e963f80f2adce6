"""Limb arithmetic, curve, hash and Merkle ops with their CUDA kernels."""
