"""The ZK proof plane's hashing: Poseidon over the BN254 scalar field.

  * `poseidon`: the pure-Python oracle, pinned to the published
    poseidonperm_x5_254_3 parameter set (a copy of the JAX package's);
  * `poseidon_torch`: the batched path on the port's limb substrate, whose
    field products run the csrc/fp.cu kernels on the card;
  * `merkle`: binary Poseidon-Merkle trees and batched proof checks.
"""

from . import merkle, poseidon, poseidon_torch  # noqa: F401

__all__ = ["poseidon", "poseidon_torch", "merkle"]
