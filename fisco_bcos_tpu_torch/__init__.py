"""PyTorch + CUDA port of the fisco_bcos_tpu crypto plane.

The default chain's block crypto path (Keccak-256 tx hashing, secp256k1
sender recovery, Keccak width-16 Merkle roots, commit-seal verification)
runs here on an NVIDIA Hopper card through hand-written CUDA kernels
(`csrc/`), each with a plain PyTorch version beside it that the CPU tests
hold bit-exact against the JAX package. This package imports torch and
numpy only; it never imports jax or fisco_bcos_tpu.
"""
