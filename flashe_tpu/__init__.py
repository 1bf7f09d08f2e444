"""FLASHE on JAX: a secure-aggregation framework for cross-silo federated
learning.

A from-scratch reimplementation of the capability set of SamuelGong/FLASHE
(arXiv:2109.00675, a fork of FATE v1.2.0) for an NVIDIA GPU accelerator:

- the FLASHE additively-symmetric HE cipher (PRP-derived double masking
  mod 2^m) as vectorized JAX lane programs and a fused CUDA kernel,
- ACIQ quantization with stochastic rounding,
- general-HE baselines (Paillier / BFV / CKKS) as limb/NTT kernels,
- a guest/host/arbiter aggregation protocol over a tag-addressed
  federation transport,
- a pure-JAX trainer harness and multi-device sharding via jax.sharding.

Reference parity map: see SURVEY.md section 2 and docs/PARITY.md.
"""

__version__ = "0.1.0"
