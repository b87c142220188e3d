"""LMC kernel specification: static structure + parameter pytree factory.

Functional parity with the reference's ``FunctionalKernel``
(runlmc/lmc/functional_kernel.py:12-302), redesigned for JAX: the *spec*
(kernel kinds, ranks, active-dims grouping) is a hashable static object
usable as a jit static argument; the *parameters* (coregionalization
vectors/diagonals, kernel hyperparameters, noise) are a plain pytree of
raw unconstrained arrays produced by :meth:`init_raw_params`.

The LMC covariance between inputs x, x' on outputs a, b is

    K((x,a), (x',b)) = sum_q B_q[a,b] k_q(||x - x'||),
    B_q = A_q^T A_q + diag(kappa_q)

with three kernel kinds (parity: functional_kernel.py:199-209):
  'lmc'   rank-r_q trainable A_q, trainable positive kappa_q
  'slfm'  rank-1 trainable A_q, kappa_q fixed at 0
  'indep' A_q = 0 fixed, kappa_q = e_d fixed (one independent GP per
          listed output)
"""

import dataclasses
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import scipy.stats

from runlmc_tpu.kernels.stationary import StationaryKernel
from runlmc_tpu.params import POSITIVE


@dataclasses.dataclass(frozen=True)
class LMCKernelSpec:
    """Static spec for an LMC kernel over D outputs.

    Build with the same vocabulary as the reference constructor
    (functional_kernel.py:88-137): ``lmc_kernels`` + ``lmc_ranks``,
    ``slfm_kernels``, ``indep_gp`` (+ ``indep_gp_index``).
    """

    D: int
    kernels: Tuple[StationaryKernel, ...]  # lmc, then slfm, then indep
    kinds: Tuple[str, ...]  # 'lmc' | 'slfm' | 'indep' per kernel
    ranks: Tuple[int, ...]  # A_q rank (lmc: r_q; slfm: 1; indep: 0)
    indep_idx: Tuple[int, ...]  # for each 'indep' kernel, its output index
    P: Optional[int] = None  # input dimension; set via with_input_dim

    # ---------------------------------------------------------------- init

    @staticmethod
    def create(
        D,
        lmc_kernels=None,
        lmc_ranks=None,
        slfm_kernels=None,
        indep_gp=None,
        indep_gp_index=None,
    ):
        if not D:
            raise ValueError("D should be specified")
        lmc_kernels = list(lmc_kernels or [])
        lmc_ranks = list(lmc_ranks or [])
        slfm_kernels = list(slfm_kernels or [])
        indep_gp = list(indep_gp or [])
        if not lmc_kernels and not slfm_kernels and not indep_gp:
            raise ValueError("number of kernels should be > 0")
        if len(lmc_kernels) != len(lmc_ranks):
            raise ValueError("# LMC kernels should equal # LMC ranks")
        if not all(r > 0 for r in lmc_ranks):
            raise ValueError("LMC ranks must be positive")
        indep_gp_index = list(
            indep_gp_index
            if indep_gp_index is not None
            else range(len(indep_gp))
        )
        if len(indep_gp) != len(indep_gp_index):
            raise ValueError("indep GP kernel count must match indices")

        kernels = tuple(lmc_kernels + slfm_kernels + indep_gp)
        kinds = tuple(
            ["lmc"] * len(lmc_kernels)
            + ["slfm"] * len(slfm_kernels)
            + ["indep"] * len(indep_gp)
        )
        ranks = tuple(
            list(lmc_ranks) + [1] * len(slfm_kernels) + [0] * len(indep_gp)
        )
        return LMCKernelSpec(
            D=D,
            kernels=kernels,
            kinds=kinds,
            ranks=ranks,
            indep_idx=tuple(indep_gp_index),
        )

    # ------------------------------------------------------------ structure

    @property
    def Q(self):
        return len(self.kernels)

    def with_input_dim(self, P):
        """Resolve each kernel's active dims against input dimension P
        (parity: functional_kernel.py:144-167 ``set_input_dim``)."""
        if self.P == P:
            return self
        if self.P is not None:
            raise ValueError("cannot set input dimension twice")
        all_dims = tuple(range(P))
        kernels = tuple(
            k.with_active_dims(k.active_dims or all_dims)
            for k in self.kernels
        )
        return dataclasses.replace(self, kernels=kernels, P=P)

    @property
    def active_dims(self) -> Dict[Tuple[int, ...], Tuple[int, ...]]:
        """Map active-dims tuple -> kernel indices with those dims, in
        kernel order (insertion order matches the reference's grouping)."""
        assert self.P is not None, "call with_input_dim first"
        groups = {}
        for i, k in enumerate(self.kernels):
            groups.setdefault(k.active_dims, []).append(i)
        return {k: tuple(v) for k, v in groups.items()}

    def counts(self, active_dim):
        """(num_lmc, num_slfm, num_indep) within one active-dims group."""
        idxs = self.active_dims[active_dim]
        kinds = [self.kinds[i] for i in idxs]
        return (
            kinds.count("lmc"),
            kinds.count("slfm"),
            kinds.count("indep"),
        )

    def total_rank(self, active_dim):
        """Total coregionalization rank within a group (parity:
        functional_kernel.py:225-232)."""
        return sum(
            self.ranks[i]
            for i in self.active_dims[active_dim]
            if self.kinds[i] != "indep"
        )

    def non_indep_idxs(self, idxs):
        """Parity: functional_kernel.py:297-302."""
        return tuple(i for i in idxs if self.kinds[i] != "indep")

    # ----------------------------------------------------------- parameters

    def init_raw_params(self, seed=0):
        """Initial raw-parameter pytree.

        Initialization parity (functional_kernel.py:171-209): trainable
        A_q entries ~ truncnorm(-1, 1); lmc kappa_q = 1 (positive,
        softplus-raw); slfm/indep coregionalization fixed (kept in the
        spec, not the params); noise = 0.1 per output.
        """
        rng = np.random.RandomState(seed)
        trunc = scipy.stats.truncnorm(-1, 1)
        coreg_vecs = {}
        coreg_diags = {}
        kernel_params = {}
        for q, (kind, rank) in enumerate(zip(self.kinds, self.ranks)):
            if kind in ("lmc", "slfm"):
                coreg_vecs["q%d" % q] = trunc.rvs(
                    size=(rank, self.D), random_state=rng
                )
            if kind == "lmc":
                coreg_diags["q%d" % q] = np.asarray(
                    POSITIVE.inverse(np.ones(self.D))
                )
            kp = self.kernels[q].init_raw_params()
            if kp:
                kernel_params["q%d" % q] = kp
        return {
            "coreg_vecs": coreg_vecs,
            "coreg_diags": coreg_diags,
            "kernels": kernel_params,
            "noise": np.asarray(POSITIVE.inverse(0.1 * np.ones(self.D))),
        }

    # -------------------------------------------------- jit-side evaluation

    def _dtype(self, raw_params):
        """Computation dtype, inherited from the parameter leaves (so an
        f32-cast parameter pytree yields a pure-f32 operator even under
        jax x64 — required by the mixed-precision inner solve path)."""
        return jnp.asarray(raw_params["noise"]).dtype

    def coreg_vec(self, raw_params, q):
        """A_q as an (r_q, D) array (fixed zeros for indep kernels)."""
        if self.kinds[q] == "indep":
            return jnp.zeros((1, self.D), dtype=self._dtype(raw_params))
        return jnp.asarray(raw_params["coreg_vecs"]["q%d" % q])

    def coreg_diag(self, raw_params, q):
        """kappa_q as a (D,) array (constrained; fixed for slfm/indep)."""
        kind = self.kinds[q]
        dtype = self._dtype(raw_params)
        if kind == "lmc":
            return POSITIVE.forward(raw_params["coreg_diags"]["q%d" % q])
        if kind == "slfm":
            return jnp.zeros(self.D, dtype=dtype)
        basis = np.zeros(self.D)
        basis[self.indep_idx[self._indep_pos(q)]] = 1.0
        return jnp.asarray(basis, dtype=dtype)

    def _indep_pos(self, q):
        return [i for i, k in enumerate(self.kinds) if k == "indep"].index(q)

    def coreg_mats(self, raw_params, idxs=None):
        """B_q = A_q^T A_q + diag(kappa_q), stacked (|idxs|, D, D)
        (parity: functional_kernel.py:280-287)."""
        if idxs is None:
            idxs = range(self.Q)
        mats = []
        for q in idxs:
            a = self.coreg_vec(raw_params, q)
            # full-f32 product: B_q feeds the f32 Woodbury factorization
            # (the default may run f32 products in TF32 on GPUs)
            aa = jnp.matmul(a.T, a, precision=jax.lax.Precision.HIGHEST)
            mats.append(aa + jnp.diag(self.coreg_diag(raw_params, q)))
        return jnp.stack(mats)

    def noise(self, raw_params):
        """Constrained per-output noise vector epsilon (D,)."""
        return POSITIVE.forward(jnp.asarray(raw_params["noise"]))

    def eval_kernel(self, raw_params, q, dists):
        kp = raw_params["kernels"].get("q%d" % q, {})
        return self.kernels[q].from_dist(kp, dists)

    def eval_kernels_stacked(self, raw_params, dists, idxs):
        """Stacked k_q(dists) for kernel indices ``idxs`` — (|idxs|, ...)
        (parity: functional_kernel.py:241-244 eval_kernels_fixed_dim)."""
        return jnp.stack(
            [self.eval_kernel(raw_params, q, dists) for q in idxs]
        )
