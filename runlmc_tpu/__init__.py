"""
runlmc_tpu — a JAX/XLA framework for matrix-free inference and
hyperparameter learning of multi-output Gaussian processes under the
Linear Model of Coregionalization (LMC), for accelerators.

This is a from-scratch rebuild of the capabilities of vlad17/runlmc
(reference layout surveyed in SURVEY.md):

- the SKI covariance ``K = W K_UU W^T + diag(eps)`` is evaluated as one
  fused, jitted matvec: interpolation scatter -> batched n-D real FFT ->
  coregionalization einsum -> inverse FFT -> interpolation gather;
- all hyperparameter gradients come from JAX autodiff of a stochastic
  MLL surrogate (Hutchinson trace estimation), replacing the reference's
  hand-derived per-parameter gradient loops
  (reference: runlmc/lmc/likelihood.py:48-96);
- linear solves are batched MINRES/CG in ``lax.while_loop`` with per-RHS
  convergence masks, sharded over a ``jax.sharding.Mesh`` in place of the
  reference's ``multiprocessing.Pool`` (reference:
  runlmc/lmc/stochastic_deriv.py:51-52).
"""

__version__ = "0.1.0"

from runlmc_tpu import config
from runlmc_tpu.kernels import (
    RBF,
    IdentityKern,
    Matern32,
    Scaled,
    StdPeriodic,
)
from runlmc_tpu.lmc.kernel_spec import LMCKernelSpec
from runlmc_tpu.metrics import Metrics
from runlmc_tpu.models import AdaDelta, ExactLMC, InterpolatedLLGP, MultiGP
from runlmc_tpu.priors import Gamma, Gaussian, HalfLaplace, InverseGamma

__all__ = [
    "config",
    "RBF",
    "Matern32",
    "StdPeriodic",
    "IdentityKern",
    "Scaled",
    "LMCKernelSpec",
    "Metrics",
    "MultiGP",
    "InterpolatedLLGP",
    "ExactLMC",
    "AdaDelta",
    "Gaussian",
    "Gamma",
    "InverseGamma",
    "HalfLaplace",
]
