"""The ZK proof plane's hashing: Poseidon over the BN254 scalar field.

  * `poseidon`: the pure-Python oracle, pinned to the published
    poseidonperm_x5_254_3 parameter set (a copy of the JAX package's);
  * `poseidon_torch`: the batched path on the port's limb substrate, whose
    field products run the csrc/fp.cu kernels on the card;
  * `merkle`: binary Poseidon-Merkle trees and batched proof checks;
  * `proof`: the verifiable-serving glue: block proof bundles rendered
    once at commit into the RPC QueryCache, flat batched verification of
    width-16 ledger proofs (one suite hash batch), and the ZkPlane
    counters behind `bcos_zk_*` / getSystemStatus.
"""

from . import merkle, poseidon, poseidon_torch, proof  # noqa: F401

__all__ = ["poseidon", "poseidon_torch", "merkle", "proof"]
