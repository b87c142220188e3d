"""The reference's example notebook (examples/example.ipynb cells 2-5)
as a runnable script: two noisy outputs (sin / offset-sin), a Q=2
rank-1 RBF LMC kernel, fit + predict + quantiles.

Run:  python examples/example.py          (GPU if available)
      JAX_PLATFORMS=cpu python examples/example.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from runlmc_tpu import AdaDelta, InterpolatedLLGP, LMCKernelSpec, RBF


def main():
    rng = np.random.default_rng(1234)

    # ragged two-output dataset (reference cell 2)
    n0, n1 = 100, 65
    X0 = np.sort(rng.uniform(0, 2 * np.pi, n0))
    X1 = np.sort(rng.uniform(0, 2 * np.pi, n1))
    Y0 = np.sin(X0) + 0.1 * rng.standard_normal(n0)
    Y1 = np.sin(X1 + np.pi / 8) + 0.1 * rng.standard_normal(n1)

    # Q=2 rank-1 RBF LMC kernel (reference cell 3)
    spec = LMCKernelSpec.create(
        D=2,
        lmc_kernels=[RBF(name="rbf0"), RBF(name="rbf1")],
        lmc_ranks=[1, 1],
    )
    # tolerance 1e-3: the reference default (1e-4 absolute) assumes f64;
    # without x64 enabled the model runs float32, whose refinement floor
    # sits just above 1e-4 on this system — request what the dtype can
    # certify
    import jax

    tol = 1e-4 if jax.config.jax_enable_x64 else 1e-3
    lmc = InterpolatedLLGP([X0, X1], [Y0, Y1], functional_kernel=spec,
                           seed=0, tolerance=tol)
    print("objective:", lmc.objective)
    print("log-likelihood before fit: %.2f" % lmc.log_likelihood())

    info = lmc.optimize(optimizer=AdaDelta(max_it=50, verbosity=10))
    print("fit: %d iterations, final grad norm %.3e"
          % (info["n_iter"], info["grad_norm"]))
    print("log-likelihood after fit:  %.2f" % lmc.log_likelihood())

    # predict on a dense grid (reference cell 5)
    Xt = np.linspace(0, 2 * np.pi, 50)
    (mu0, mu1), (v0, v1) = lmc.predict([Xt, Xt])
    lo_hi = lmc.predict_quantiles([Xt, Xt], quantiles=(2.5, 97.5))
    rmse0 = np.sqrt(np.mean((mu0 - np.sin(Xt)) ** 2))
    rmse1 = np.sqrt(np.mean((mu1 - np.sin(Xt + np.pi / 8)) ** 2))
    print("predictive RMSE vs truth: %.3f / %.3f" % (rmse0, rmse1))
    cover0 = np.mean(
        (lo_hi[0][:, 0] <= np.sin(Xt)) & (np.sin(Xt) <= lo_hi[0][:, 1])
    )
    print("95%% interval coverage (output 0): %.0f%%" % (100 * cover0))
    assert rmse0 < 0.2 and rmse1 < 0.2


if __name__ == "__main__":
    main()
