"""Structured linear-operator algebra as differentiable JAX pytrees.

Functional parity with the reference's MVM operator inventory
(runlmc/linalg/*.py — see SURVEY.md section 2.1), redesigned for JAX:

- every operator is a pytree dataclass (``runlmc_tpu.utils.struct``)
  whose ``matvec`` accepts *batched* operands ``v`` of shape ``(..., n)``
  — a whole stack of
  right-hand sides flows through one fused XLA computation (the
  reference's ``matmat`` is a Python column loop,
  runlmc/linalg/matrix.py:55-67);
- operators are differentiable w.r.t. their array leaves, so covariance
  hyperparameter gradients come from autodiff rather than hand-derived
  dK/dtheta operators;
- ``as_dense`` exists for oracle tests only (parity: ``as_numpy``,
  runlmc/linalg/matrix.py:39).

Correspondence (reference file -> class here):
  matrix.py `Matrix`              -> LinearOperator (+ `wrap`)
  numpy_matrix.py `NumpyMatrix`   -> Dense
  identity.py `Identity`          -> Identity
  diag.py `Diag`                  -> Diag
  toeplitz.py `Toeplitz`          -> Toeplitz
  bttb.py `BTTB`                  -> BTTB
  kronecker.py `Kronecker`        -> Kronecker
  block_diag.py `BlockDiag`       -> BlockDiag
  block_matrix.py `SymmSquareBlockMatrix` -> SymmSquareBlock
  sum_matrix.py `SumMatrix`       -> Sum
  composition.py `Composition`    -> Composition
  approx/ski.py `SKI`             -> SKI (in runlmc_tpu/ops/interpolation.py)
  shur.py `shur`                  -> omitted (dead code in the reference;
                                     not imported anywhere there either)
"""

from typing import Any, Callable, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from runlmc_tpu.ops import bttb as bttb_ops
from runlmc_tpu.utils import struct


class LinearOperator:
    """Abstract square/rectangular linear operator with batched matvec.

    ``matvec(v)``: v has shape (..., ncols); returns (..., nrows). All
    concrete subclasses are pytrees and can be passed through jit/vmap/grad.
    """

    @property
    def shape(self) -> Tuple[int, int]:
        raise NotImplementedError

    def matvec(self, v):
        raise NotImplementedError

    def matmat(self, m):
        """Right-multiply by a matrix of column vectors: (ncols, k) ->
        (nrows, k). Implemented via the batched matvec."""
        return self.matvec(m.T).T

    def as_dense(self):
        """Densify by applying the batched matvec to the identity. Test
        oracle only — quadratic memory."""
        n = self.shape[1]
        return self.matvec(jnp.eye(n, dtype=jnp.result_type(float))).T

    def upper_eig_bound(self):
        """A cheap upper bound on the largest eigenvalue (symmetric
        operators); used for conditioning diagnostics."""
        raise NotImplementedError

    @staticmethod
    def wrap(shape, mvm: Callable):
        """Adapt a closure into an operator (parity: reference
        runlmc/linalg/matrix.py:72-74)."""
        return _Wrapped(opshape=tuple(shape), fn=mvm)


@struct.dataclass
class _Wrapped(LinearOperator):
    fn: Callable = struct.field(static=True)
    opshape: Tuple[int, int] = struct.field(static=True)

    @property
    def shape(self):
        return self.opshape

    def matvec(self, v):
        return self.fn(v)


@struct.dataclass
class Dense(LinearOperator):
    """Dense matrix operator (parity: runlmc/linalg/numpy_matrix.py)."""

    a: Any

    @property
    def shape(self):
        return self.a.shape

    def matvec(self, v):
        # full-f32 multiplies (the default may run f32 products in
        # TF32 on GPUs): this operator is the dense oracle in tests and
        # a Krylov operand in its own right
        return jnp.einsum("ij,...j->...i", self.a, v,
                          precision=jax.lax.Precision.HIGHEST)

    def as_dense(self):
        return self.a

    def upper_eig_bound(self):
        # Gershgorin: max row abs sum.
        return jnp.abs(self.a).sum(axis=1).max()


@struct.dataclass
class Identity(LinearOperator):
    """Identity operator (parity: runlmc/linalg/identity.py)."""

    n: int = struct.field(static=True)

    @property
    def shape(self):
        return (self.n, self.n)

    def matvec(self, v):
        return v

    def upper_eig_bound(self):
        return 1.0


@struct.dataclass
class Diag(LinearOperator):
    """Diagonal operator (parity: runlmc/linalg/diag.py)."""

    d: Any

    @property
    def shape(self):
        return (self.d.shape[0], self.d.shape[0])

    def matvec(self, v):
        return self.d * v

    def as_dense(self):
        return jnp.diag(self.d)

    def upper_eig_bound(self):
        return jnp.max(self.d)


@struct.dataclass
class BTTB(LinearOperator):
    """Symmetric block-Toeplitz-of-Toeplitz-blocks operator over a P-dim
    grid, stored as its first row plus a precomputed Fourier symbol.

    Parity: reference runlmc/linalg/bttb.py:23-155 (which recomputes a
    numpy rfftn per matvec); here the symbol FFT is computed once at
    construction and matvecs batch over leading axes.
    """

    top: Any
    symbol_fft: Any
    sizes: Tuple[int, ...] = struct.field(static=True)

    @classmethod
    def build(cls, top, sizes):
        sizes = tuple(int(s) for s in sizes)
        top = jnp.asarray(top)
        if top.ndim != 1:
            raise ValueError("top must be 1-D, got shape %s" % (top.shape,))
        if int(np.prod(sizes)) != top.shape[0]:
            raise ValueError(
                "sizes %s do not match top length %d" % (sizes, top.shape[0])
            )
        return cls(
            top=top, symbol_fft=bttb_ops.bttb_fft(top, sizes), sizes=sizes
        )

    @property
    def shape(self):
        n = self.top.shape[0]
        return (n, n)

    def matvec(self, v):
        return bttb_ops.bttb_matvec(self.symbol_fft, v, self.sizes)

    def as_dense(self):
        return bttb_ops.bttb_dense(self.top, self.sizes)

    def upper_eig_bound(self):
        return bttb_ops.bttb_eig_upper_bound(
            np.asarray(self.top), self.sizes
        )


def Toeplitz(top):
    """Symmetric Toeplitz operator from its first row — the 1-D special
    case of :class:`BTTB` (parity: runlmc/linalg/toeplitz.py:17-92, whose
    O(n) Gershgorin bound is :func:`runlmc_tpu.ops.bttb.toeplitz_eig_upper_bound`).
    """
    top = jnp.asarray(top)
    return BTTB.build(top, (top.shape[0],))


@struct.dataclass
class Kronecker(LinearOperator):
    """Lazy Kronecker product A (x) B of two square operators.

    matvec via the reshape trick (parity: runlmc/linalg/kronecker.py:39-46):
    for row-major v.reshape(na, nb), (A (x) B) v = A V_B where V_B applies B
    to each row — both sides batched, no materialization.
    """

    a: Any
    b: Any

    @property
    def shape(self):
        n = self.a.shape[0] * self.b.shape[0]
        return (n, n)

    def matvec(self, v):
        na, nb = self.a.shape[0], self.b.shape[0]
        batch = v.shape[:-1]
        x = v.reshape(batch + (na, nb))
        x = self.b.matvec(x)  # B applied along last axis, batched over na
        x = jnp.swapaxes(x, -1, -2)  # (..., nb, na)
        x = self.a.matvec(x)  # A applied along last axis, batched over nb
        x = jnp.swapaxes(x, -1, -2)
        return x.reshape(batch + (na * nb,))

    def upper_eig_bound(self):
        return self.a.upper_eig_bound() * self.b.upper_eig_bound()


@struct.dataclass
class BlockDiag(LinearOperator):
    """Direct sum of (possibly rectangular) blocks (parity:
    runlmc/linalg/block_diag.py:12-49). Blocks may be heterogeneous; the
    matvec slices the operand per block. For the homogeneous all-BTTB case
    the LMC fast path bypasses this class entirely with a stacked Fourier
    contraction (runlmc_tpu/lmc/grid.py)."""

    blocks: Any

    @property
    def shape(self):
        rows = sum(b.shape[0] for b in self.blocks)
        cols = sum(b.shape[1] for b in self.blocks)
        return (rows, cols)

    def matvec(self, v):
        outs = []
        off = 0
        for b in self.blocks:
            outs.append(b.matvec(v[..., off : off + b.shape[1]]))
            off += b.shape[1]
        return jnp.concatenate(outs, axis=-1)

    def upper_eig_bound(self):
        return max(b.upper_eig_bound() for b in self.blocks)


@struct.dataclass
class SymmSquareBlock(LinearOperator):
    """D x D symmetric array of equal-size square blocks (parity:
    runlmc/linalg/block_matrix.py:13-54; the reference runs a double Python
    loop of matvecs — here each block row is applied to the full stacked
    operand in a batched call)."""

    blocks: Any  # list of D lists of D operators, blocks[i][j] == blocks[j][i].T

    @property
    def shape(self):
        d = len(self.blocks)
        m = self.blocks[0][0].shape[0]
        return (d * m, d * m)

    def matvec(self, v):
        d = len(self.blocks)
        m = self.blocks[0][0].shape[0]
        batch = v.shape[:-1]
        x = v.reshape(batch + (d, m))
        outs = []
        for i in range(d):
            acc = 0
            for j in range(d):
                acc = acc + self.blocks[i][j].matvec(x[..., j, :])
            outs.append(acc)
        return jnp.stack(outs, axis=-2).reshape(batch + (d * m,))

    def upper_eig_bound(self):
        # 1-norm of the matrix of per-block bounds (parity:
        # runlmc/linalg/block_matrix.py:46-49).
        d = len(self.blocks)
        bounds = np.array(
            [
                [float(self.blocks[i][j].upper_eig_bound()) for j in range(d)]
                for i in range(d)
            ]
        )
        return float(np.abs(bounds).sum(axis=1).max())


@struct.dataclass
class Sum(LinearOperator):
    """Lazy sum of operators (parity: runlmc/linalg/sum_matrix.py:9-45)."""

    terms: Any

    @property
    def shape(self):
        return self.terms[0].shape

    def matvec(self, v):
        acc = self.terms[0].matvec(v)
        for t in self.terms[1:]:
            acc = acc + t.matvec(v)
        return acc

    def upper_eig_bound(self):
        # Weyl: sum of bounds (parity: runlmc/linalg/sum_matrix.py:43-45).
        return sum(t.upper_eig_bound() for t in self.terms)


@struct.dataclass
class Composition(LinearOperator):
    """Product M_1 M_2 ... M_k applied right-to-left (parity:
    runlmc/linalg/composition.py:9-22)."""

    factors: Any

    @property
    def shape(self):
        return (self.factors[0].shape[0], self.factors[-1].shape[1])

    def matvec(self, v):
        for f in reversed(self.factors):
            v = f.matvec(v)
        return v

    def upper_eig_bound(self):
        b = 1.0
        for f in self.factors:
            b = b * f.upper_eig_bound()
        return b
