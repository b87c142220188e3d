"""ExactLMC — dense O(n^3) exact LMC multi-output GP.

Plays the role of the reference's GPy-backed baseline wrapper ``GPyLMC``
(runlmc/models/gpy_lmc.py:20-124) without the external GPy dependency:
the same LMC kernel spec, evaluated densely, with exact Cholesky
likelihood, autodiff gradients, and L-BFGS optimization. Used as the
cross-validation oracle for InterpolatedLLGP and as a small-data model
in its own right.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import scipy.optimize
from jax.flatten_util import ravel_pytree

from runlmc_tpu.lmc import likelihood as lk
from runlmc_tpu.models.multigp import MultiGP

_LOG = logging.getLogger(__name__)


class ExactLMC(MultiGP):
    def __init__(
        self,
        Xs,
        Ys,
        functional_kernel=None,
        normalize=True,
        name="exact-lmc",
        seed=0,
        dtype=None,
    ):
        super().__init__(Xs, Ys, normalize=normalize, name=name)
        if functional_kernel is None:
            raise ValueError("functional_kernel must be provided")
        self.spec = functional_kernel.with_input_dim(self.input_dim)
        self.dtype = dtype or (
            jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
        )
        self.data = lk.flatten_data(self.Xs, self.Ys)
        self.y = jnp.asarray(self.data.y, dtype=self.dtype)
        self._X = jnp.asarray(self.data.X, dtype=self.dtype)
        self._oidx = jnp.asarray(self.data.output_idx)

        raw = self.spec.init_raw_params(seed=seed)
        self.params = jax.tree.map(
            lambda a: jnp.asarray(a, dtype=self.dtype), raw
        )
        _, self._unravel = ravel_pytree(self.params)

        spec = self.spec

        @jax.jit
        def value_and_grad(x_flat):
            def neg_mll(p):
                return -lk.exact_mll(
                    spec, p, self._X, self._oidx, self.y
                )

            v, g = jax.value_and_grad(neg_mll)(self._unravel(x_flat))
            return v, ravel_pytree(g)[0]

        self._jit_vg = value_and_grad

    @property
    def param_array(self):
        return np.asarray(ravel_pytree(self.params)[0])

    @param_array.setter
    def param_array(self, x):
        self.params = self._unravel(jnp.asarray(x, dtype=self.dtype))

    def log_likelihood(self):
        v, _ = self._jit_vg(jnp.asarray(self.param_array))
        return -float(v)

    def optimize(self, max_iters=100, **kwargs):
        """L-BFGS on the exact negative MLL with autodiff gradients."""

        def fun(x):
            v, g = self._jit_vg(jnp.asarray(x, dtype=self.dtype))
            return float(v), np.asarray(g, dtype=float)

        res = scipy.optimize.minimize(
            fun,
            self.param_array,
            jac=True,
            method="L-BFGS-B",
            options={"maxiter": max_iters},
        )
        self.param_array = res.x
        _LOG.info("%s: L-BFGS done, nll %f", self.name, res.fun)
        return res

    def _raw_predict(self, Xs):
        lens = [len(X) for X in Xs]
        td = lk.flatten_data(Xs, [np.zeros(len(X)) for X in Xs])
        Xt = jnp.asarray(td.X, dtype=self.dtype)
        ot = jnp.asarray(td.output_idx)

        K = lk.exact_dense_K(self.spec, self.params, self._X, self._oidx)
        # force full-precision multiplies inside the blocked
        # cholesky/trisolve (TF32 by default for f32 on GPUs)
        with jax.default_matmul_precision("highest"):
            L = jnp.linalg.cholesky(K)
            alpha = jax.scipy.linalg.cho_solve((L, True), self.y)
        K_star = lk.cross_kernel(
            self.spec, self.params, Xt, ot, self._X, self._oidx
        )
        mean = np.asarray(K_star @ alpha)

        with jax.default_matmul_precision("highest"):
            sol = jax.scipy.linalg.cho_solve((L, True), K_star.T)
        explained = np.asarray(jnp.sum(K_star * sol.T, axis=1))
        # prior variance of each test point (incl. noise), minus explained
        prior = np.zeros(sum(lens))
        k0 = {
            q: float(
                self.spec.eval_kernel(
                    self.params, q, jnp.zeros((), self.dtype)
                )
            )
            for q in range(self.spec.Q)
        }
        noise = np.asarray(self.spec.noise(self.params))
        for d in range(self.output_dim):
            v = noise[d]
            for q in range(self.spec.Q):
                a = np.asarray(self.spec.coreg_vec(self.params, q))
                kap = np.asarray(self.spec.coreg_diag(self.params, q))
                v += (np.square(a[:, d]).sum() + kap[d]) * k0[q]
            prior[np.asarray(td.output_idx) == d] = v
        var = prior - explained
        var[var < 0] = 0

        ends = np.cumsum(lens)[:-1]
        return np.split(mean, ends), np.split(var, ends)
