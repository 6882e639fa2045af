"""dindel_tpu — an accelerator-native indel-realignment caller.

A from-scratch reimplementation of the Dindel method (candidate indels from
read CIGARs define ~120bp realignment windows; per window, candidate
haplotypes are scored against every read with a pair-HMM observation model
and Bayesian inference emits genotype likelihoods and indel calls), designed
for JAX/XLA on an NVIDIA GPU:

- the (reads x haplotypes) pair-HMM likelihood matrix is computed by a
  batched max-product HMM (``dindel_tpu.hmm``): pure JAX/XLA anywhere, or
  a fused CUDA kernel called through JAX's FFI;
- window-level Bayesian calling (diploid / pooled variational-Bayes EM) is
  float64 NumPy/JAX (``dindel_tpu.infer``) for bit-stable calls;
- the host data plane (BGZF/BAM/FASTA) is our own implementation from the
  SAM/BAM spec (``dindel_tpu.io``), no third-party bioinformatics deps;
- scale-out is data-parallel over windows via ``jax.sharding`` meshes
  (``dindel_tpu.parallel``).

Behavioral reference: genome/dindel-tgi (C++/Python2), see SURVEY.md.
"""

__version__ = "0.1.0"
