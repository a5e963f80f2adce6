"""PyTorch + CUDA port of the fisco_bcos_tpu crypto plane.

The block crypto paths of both chains (tx hashing, sender recovery,
width-16 Merkle roots, commit-seal verification; secp256k1 + Keccak-256
on the default chain, SM2 + SM3 on the SM chain) run here on an NVIDIA
Hopper card through hand-written CUDA kernels (`csrc/`), each with a
plain PyTorch version beside it that the CPU tests hold bit-exact
against the JAX package. This package imports torch and
numpy only; it never imports jax or fisco_bcos_tpu.
"""
