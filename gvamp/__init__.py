"""gVAMP in JAX: whole-genome Vector Approximate Message Passing on GPUs.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
medical-genomics-group/gVAMP (C++/MPI/AVX reference): EM-flavoured VAMP for
Bayesian whole-genome regression ``y = A x + noise`` where ``A`` is an N x M
standardized genotype matrix kept in device memory in 2-bit packed PLINK
``.bed`` form and decoded on the fly inside fused matvec kernels.

Supported model families (reference parity):
  * linear        -- spike-and-slab mixture prior, LMMSE via preconditioned CG
                     (reference: vamp.cpp:190 infere_linear)
  * bin_class     -- probit regression with fixed covariate effects
                     (reference: vamp_probit.cpp:20 infere_bin_class)
  * robust        -- Huber-loss robust regression (reference: vamp_Huber.cpp:24)
plus the dual / N-space "XXT" LMMSE denoiser (reference: denoiserXXT.cpp),
LOO / LOCO association p-values (reference: data.cpp:1108,1235), simulation
drivers, and the full run-mode CLI (infere/test/both/restart/predict/
predict_single/pvals-calc; reference: main_real.cpp).

Distribution model: markers are sharded over a ``jax.sharding.Mesh`` axis
("m"); every ``A @ x`` ends in a ``psum`` over that axis (NCCL on GPUs; the
replacement for the reference's ``MPI_Allreduce`` of N doubles, data.cpp:928).
"""

__version__ = "0.1.0"

__all__ = ["__version__"]
