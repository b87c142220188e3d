"""Cubic-convolution grid interpolation as fixed-width gather/scatter.

The reference stores the SKI interpolation matrix W as a scipy CSR with
exactly 4 (1-D) or 16 (2-D) nonzeros per row
(runlmc/approx/interpolation.py:56-116, 218-328). XLA has no sparse
formats — but a fixed-nnz-per-row sparse matrix is just a dense gather:

  W v      = sum_t  weights[:, t] * v[indices[:, t]]        (gather + dot)
  W^T x    = scatter-add of weights * x into the grid        (segment sum)

Both batch over arbitrary leading axes and fuse into the surrounding FFT
matvec under jit. Index/weight construction happens host-side in numpy at
model-build time (it depends only on data locations, never on
hyperparameters).
"""

import logging
from typing import Any, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from runlmc_tpu.ops.operators import LinearOperator
from runlmc_tpu.utils import struct

_LOG = logging.getLogger(__name__)


def cubic_kernel(x):
    """Keys cubic convolution weight u(x), supported on |x| <= 2
    (parity: runlmc/approx/interpolation.py:21-53; outside the support we
    return 0 instead of raising, which is equivalent on clamped inputs and
    jit-friendly)."""
    x = np.abs(np.asarray(x, dtype=float))
    near = ((1.5 * x - 2.5) * x) * x + 1
    far = ((-0.5 * x + 2.5) * x - 4) * x + 2
    return np.where(x <= 1, near, np.where(x <= 2, far, 0.0))


def _check_grid(grid, name="grid"):
    grid = np.asarray(grid, dtype=float)
    if grid.ndim != 1:
        raise ValueError("%s must be 1-D" % name)
    if grid.size < 4:
        raise ValueError("%s size %d must be >= 4" % (name, grid.size))
    return grid


def interp_cubic(grid, samples):
    """Indices/weights of the n x m cubic interpolation matrix onto an
    equispaced 1-D grid: returns (idx, w), each (n, 4).

    Edge indices are clamped (duplicate columns accumulate, exactly like
    the reference's CSR addition — runlmc/approx/interpolation.py:104-116).
    """
    grid = _check_grid(grid)
    samples = np.asarray(samples, dtype=float).ravel()
    n = samples.size
    if n == 0:
        return np.zeros((0, 4), np.int32), np.zeros((0, 4))
    if samples.min() <= grid[0] or samples.max() >= grid[-1]:
        _LOG.warning(
            "sample range [%f, %f] outside grid range [%f, %f]",
            samples.min(), samples.max(), grid[0], grid[-1],
        )
    m = grid.size
    delta = grid[1] - grid[0]
    factors = (samples - grid[0]) / delta
    closest = np.floor(factors)
    dist = factors - closest  # in units of delta, in [0, 1)
    idx = np.empty((n, 4), dtype=np.int64)
    w = np.empty((n, 4))
    for t, conv_idx in enumerate(range(-2, 2)):
        idx[:, t] = np.clip(closest - conv_idx, 0, m - 1)
        w[:, t] = cubic_kernel(dist + conv_idx)
    return idx.astype(np.int32), w


def interp_bicubic(gridx, gridy, samples):
    """Indices/weights of the n x (mx*my) tensor-product bicubic
    interpolation matrix: returns (idx, w), each (n, 16)
    (parity: runlmc/approx/interpolation.py:218-328 — the reference builds
    this by CSR composition; the tensor product of two cubic stencils is
    algebraically identical)."""
    gridx = _check_grid(gridx, "gridx")
    gridy = _check_grid(gridy, "gridy")
    samples = np.asarray(samples, dtype=float)
    if samples.ndim != 2 or samples.shape[1] != 2:
        raise ValueError("expected (n, 2) samples, got %s" % (samples.shape,))
    n = samples.shape[0]
    if n == 0:
        return np.zeros((0, 16), np.int32), np.zeros((0, 16))
    ix, wx = interp_cubic(gridx, samples[:, 0])  # (n, 4)
    iy, wy = interp_cubic(gridy, samples[:, 1])  # (n, 4)
    my = gridy.size
    # Flattened grid index: x-major, y fastest (row-major cartesian
    # product) — matches the grid layout used for the BTTB first row.
    idx = ix[:, :, None].astype(np.int64) * my + iy[:, None, :]
    w = wx[:, :, None] * wy[:, None, :]
    return idx.reshape(n, 16).astype(np.int32), w.reshape(n, 16)


def interp_nd(grid_axes, samples):
    """Dispatch on input dimension: 1-D cubic or 2-D bicubic (parity with
    the reference's dispatch in multi_interpolant,
    runlmc/approx/interpolation.py:146-151)."""
    samples = np.asarray(samples, dtype=float)
    if len(grid_axes) == 1:
        return interp_cubic(grid_axes[0], samples.ravel())
    if len(grid_axes) == 2:
        return interp_bicubic(grid_axes[0], grid_axes[1], samples)
    raise NotImplementedError(
        "interpolation grids support 1 or 2 active dimensions; split the "
        "kernel over active_dims subsets for higher-dimensional inputs"
    )


def multi_interpolant(Xs, grid_axes):
    """Block-diagonal multi-output interpolant: stacks per-output W_i with
    column offset ``i * m`` into one (n_total, D*m) gather operator
    (parity: runlmc/approx/interpolation.py:119-176).

    ``Xs``: list of per-output sample arrays (n_i,) or (n_i, P).
    Returns an :class:`Interp`.
    """
    m = int(np.prod([len(g) for g in grid_axes]))
    idxs, ws = [], []
    for i, X in enumerate(Xs):
        idx, w = interp_nd(grid_axes, X)
        idxs.append(idx + i * m)
        ws.append(w)
    taps = 4 ** len(grid_axes)
    if idxs:
        idx = np.concatenate(idxs, axis=0)
        w = np.concatenate(ws, axis=0)
    else:
        idx = np.zeros((0, taps), np.int32)
        w = np.zeros((0, taps))
    return Interp(
        indices=jnp.asarray(idx),
        weights=jnp.asarray(w),
        ncols=len(Xs) * m,
    )


def interp_output_blocks(Xs, grid_axes):
    """Per-output DENSE interpolation blocks: list of (n_i, m) float
    arrays W_i such that the full block-diagonal W is
    diag(W_1, ..., W_D).

    Materializing the blocks turns W/W^T applications into per-output
    dense matmuls (total cost B * n * m MACs, memory n * m floats) in
    place of the gather/scatter path, whose (n * taps)-element
    scatter-add serializes on colliding indices. Host-side,
    parameter-independent.
    """
    m = int(np.prod([len(g) for g in grid_axes]))
    blocks = []
    for X in Xs:
        idx, w = interp_nd(grid_axes, X)
        dense = np.zeros((len(idx), m))
        rows = np.repeat(np.arange(len(idx)), idx.shape[1])
        np.add.at(dense, (rows, idx.ravel()), w.ravel())
        blocks.append(dense)
    return blocks


def autogrid(Xs, lo=None, hi=None, m=None):
    """Default interpolation grid: per-dim linspace covering the pooled
    data range, padded by two extra cells on each side (so the cubic
    stencil of boundary samples stays interior), with the per-dim size
    defaulting to the mean series length. Behavioral parity:
    runlmc/approx/interpolation.py:179-215.

    ``Xs``: per-output sample arrays; ``lo``/``hi``/``m``: optional
    per-dim bound/size overrides (data-range bounds always win when
    they are wider). Returns a list of P 1-D numpy axes.
    """
    stacked = np.concatenate(
        [np.asarray(X, dtype=float).reshape(len(X), -1) for X in Xs]
    )
    P = stacked.shape[1]
    for name, v in (("lo", lo), ("hi", hi), ("m", m)):
        if v is not None and len(v) != P:
            raise ValueError("%s must have length %d" % (name, P))

    data_lo = stacked.min(axis=0)
    data_hi = stacked.max(axis=0)
    lower = data_lo if lo is None else np.minimum(lo, data_lo)
    upper = data_hi if hi is None else np.maximum(hi, data_hi)
    if m is None:
        mean_len = sum(len(X) for X in Xs) // len(Xs)
        sizes = np.full(P, mean_len)
    else:
        sizes = np.asarray(m)

    cell = (upper - lower) / sizes
    return [
        np.linspace(lower[p] - 2 * cell[p], upper[p] + 2 * cell[p],
                    int(sizes[p]) + 4)
        for p in range(P)
    ]


@struct.dataclass
class Interp(LinearOperator):
    """Fixed-width sparse interpolation operator W: (n, ncols) with
    ``taps`` nonzeros per row, stored as gather indices + weights."""

    indices: Any  # (n, taps) int32
    weights: Any  # (n, taps)
    ncols: int = struct.field(static=True)

    @property
    def shape(self):
        return (self.indices.shape[0], self.ncols)

    def matvec(self, v):
        """W v: (..., ncols) -> (..., n) — gather + weighted sum."""
        gathered = jnp.take(v, self.indices, axis=-1)  # (..., n, taps)
        # full-f32 contraction: a reduced-precision default (TF32 on
        # GPUs, ~1e-3 relative) would floor the whole Krylov solve
        return jnp.einsum(
            "...nt,nt->...n", gathered, self.weights,
            precision=jax.lax.Precision.HIGHEST,
        )

    def rmatvec(self, x):
        """W^T x: (..., n) -> (..., ncols) — batched scatter-add.

        Duplicate (clamped-edge) indices accumulate, matching the
        reference's CSR-sum semantics.
        """
        vals = x[..., :, None] * self.weights  # (..., n, taps)
        batch = x.shape[:-1]
        flat_idx = self.indices.reshape(-1)
        flat_vals = vals.reshape(batch + (-1,))
        out = jnp.zeros(batch + (self.ncols,), dtype=vals.dtype)
        return out.at[..., flat_idx].add(flat_vals)

    @property
    def T(self):
        return _InterpT(interp=self)

    def replace_weights_dtype(self, dtype):
        return self.replace(weights=jnp.asarray(self.weights, dtype=dtype))

    def as_dense(self):
        n, m = self.shape
        out = np.zeros((n, m))
        idx = np.asarray(self.indices)
        w = np.asarray(self.weights)
        for t in range(idx.shape[1]):
            np.add.at(out, (np.arange(n), idx[:, t]), w[:, t])
        return jnp.asarray(out)


@struct.dataclass
class _InterpT(LinearOperator):
    interp: Interp

    @property
    def shape(self):
        n, m = self.interp.shape
        return (m, n)

    def matvec(self, v):
        return self.interp.rmatvec(v)

    def as_dense(self):
        return self.interp.as_dense().T


@struct.dataclass
class SKI(LinearOperator):
    """The SKI composition W K_UU W^T (parity: runlmc/approx/ski.py:8-23)."""

    grid_K: Any
    W: Interp

    @property
    def shape(self):
        n = self.W.shape[0]
        return (n, n)

    def matvec(self, v):
        return self.W.matvec(self.grid_K.matvec(self.W.rmatvec(v)))

    def as_dense(self):
        Wd = self.W.as_dense()
        hi = jax.lax.Precision.HIGHEST
        return jnp.matmul(
            jnp.matmul(Wd, self.grid_K.as_dense(), precision=hi), Wd.T,
            precision=hi,
        )

    def upper_eig_bound(self):
        # Parity: runlmc/approx/ski.py:22-23.
        n = self.W.shape[0]
        m = self.W.shape[1]
        return self.grid_K.upper_eig_bound() * n / m
