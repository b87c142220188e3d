"""The SKI grid covariance K = W K_UU W^T + diag(eps) as ONE fused,
batched, differentiable matvec.

Reference architecture (runlmc/lmc/grid_kernel.py:22-136) builds a lazy
operator *tree* — Kronecker / BlockDiag / SymmSquareBlock compositions of
BTTB operators — and each matvec walks the tree in Python, running one
numpy FFT per BTTB block. This redesign collapses the whole tree into a
single Fourier-space contraction:

    K_UU v  =  irfftn( contract(coreg, rfftn(kernels-on-grid),
                                 rfftn(v)) )

because every representation ('sum', 'bt', 'slfm') of
K_UU = sum_q B_q (x) T_q acts diagonally in the grid Fourier basis. One
forward FFT of the operand (batched over D outputs and any number of
right-hand sides), one einsum, one inverse FFT — regardless of Q. The
representations differ ONLY in the einsum path (and what is precomputed
per parameter update), mirroring the reference's asymptotics:

  'sum'  einsum('qde,qf,bef->bdf')      O(Q D^2 F)/matvec, no precompute
         (parity: _gen_sum_grid, grid_kernel.py:126-136)
  'bt'   precompute S[d,e,f] = sum_q B_q[d,e] That_q[f]  -> O(D^2 F)/matvec
         (parity: _gen_bt_grid, grid_kernel.py:115-123)
  'slfm' factored A* path + diagonal path -> O((R + D) F)/matvec
         (parity: _gen_slfm_grid, grid_kernel.py:77-112)

Representation auto-selection reproduces gen_grid_kernel's heuristic
(grid_kernel.py:49-74) on static spec metadata.

Everything in this module is differentiable w.r.t. raw hyperparameters —
the gradient path IS this same code under jax.grad.
"""

import dataclasses
from typing import Any, Optional, Tuple

import jax.numpy as jnp
import numpy as np
from jax import lax

# An f32 einsum/matmul at the default precision may run in TF32 on a GPU
# (~1e-3 relative, three decimal digits); a matvec error that size
# stalls Krylov convergence far above the solve tolerance. Every
# contraction on the solve path runs at full f32.
_HI = lax.Precision.HIGHEST

from runlmc_tpu.lmc.kernel_spec import LMCKernelSpec
from runlmc_tpu.ops import bttb as bttb_ops
from runlmc_tpu.ops.interpolation import (
    Interp,
    autogrid,
    interp_output_blocks,
    multi_interpolant,
)
from runlmc_tpu.ops.operators import LinearOperator
from runlmc_tpu.utils import struct
from runlmc_tpu.utils.np_utils import cartesian_product


# --------------------------------------------------------------------------
# Host-side grid construction (data-dependent, parameter-independent).
# --------------------------------------------------------------------------


# Above this many grid points per group (D * m), the dense (Dm, Dm)
# materialization stops paying off against the FFT path.
DENSE_MAX_GRID = 8192

# Separate, LARGER cap for the f32 Woodbury PRECONDITIONER twin of
# non-dense groups. Dense mode pays (Dm)^2 memory at the model dtype
# on every matvec, so its cap is tight; the preconditioner is built
# once per step at f32 — an O((Dm)^3) f32 Cholesky — and
# preconditioner QUALITY is what keeps
# large-grid solve iteration counts in the single digits (a twin at
# the exact fine geometry has only the f32 floor as mismatch, like
# dense mode's factor; a truly coarsened twin adds its grid's
# interpolation error, which at degraded conditioning can exceed the
# learned noise and stall PCG).
PRECOND_MAX_GRID = 16384

# Dense per-output interpolation blocks (n_d, m) turn the W / W^T
# applications of a group's SKI matvec into dense matmuls in place of
# the gather/scatter path, whose scatter-add serializes on colliding
# grid indices. Build them for NON-dense groups too whenever the total
# element count n * m stays under this budget (~400 MB at f64).
#
# DENSE_MAX_GRID, PRECOND_MAX_GRID and W_BLOCKS_MAX_ELEMS each select
# between two code paths; none is yet measured on the H100.
W_BLOCKS_MAX_ELEMS = 50_000_000


@dataclasses.dataclass(frozen=True)
class GridPlan:
    """Static per-active-dim-group plan: which kernels, which
    representation, grid sizes. Hashable — safe as a jit static arg.

    ``mode``: 'fft' runs matvecs in Fourier space (O(m log m), at the
    model dtype); 'dense' materializes the (Dm, Dm) grid kernel once
    per parameter update and runs matvecs as dense matmuls — at
    benchmark grid sizes the faster choice per matvec, and the input of
    the direct Woodbury factorization; 'tiled' computes the EXACT grid
    matvec tile-by-tile from the first rows
    (ops/bttb.py:bttb_tiled_kuu_matvec) — O(m^2) matmul work but
    O(tile*m) memory and dtype-generic, selected only by an explicit
    ``grid_mode='tiled'``.

    ``grid_shard``: optional ``(Mesh, axis_name)`` — shards the
    grid-sized axis of this group's matvecs over the named mesh axis
    via GSPMD constraints: the Fourier-frequency axis of the symbol and
    operand in 'fft' mode (the pointwise contraction shards with zero
    collectives; XLA inserts the FFT transposes), the K_UU row axis in
    'dense' mode. This is the multi-device axis for grids too large for
    one device's memory (SURVEY.md section 7 stage 8); set by passing the
    model a mesh with a 'grid' axis.
    """

    active_dim: Tuple[int, ...]
    kidxs: Tuple[int, ...]
    rep: str
    sizes: Tuple[int, ...]
    mode: str = "fft"
    grid_shard: Any = None


def _shard_last(x, grid_shard):
    """Constrain the LAST axis of ``x`` over the grid mesh axis."""
    if grid_shard is None or x is None:
        return x
    import jax
    from jax.sharding import NamedSharding, PartitionSpec

    mesh, axis = grid_shard
    spec = PartitionSpec(*([None] * (x.ndim - 1)), axis)
    return jax.lax.with_sharding_constraint(x, NamedSharding(mesh, spec))


def _shard_rows(x, grid_shard):
    """Constrain the FIRST axis of ``x`` over the grid mesh axis."""
    if grid_shard is None or x is None:
        return x
    import jax
    from jax.sharding import NamedSharding, PartitionSpec

    mesh, axis = grid_shard
    spec = PartitionSpec(axis, *([None] * (x.ndim - 1)))
    return jax.lax.with_sharding_constraint(x, NamedSharding(mesh, spec))


def choose_rep(spec: LMCKernelSpec, active_dim) -> str:
    """Representation auto-selection (parity: gen_grid_kernel,
    runlmc/lmc/grid_kernel.py:49-64)."""
    if spec.Q == 1:
        return "sum"
    tot_rank = spec.total_rank(active_dim)
    num_lmc, _, num_indep = spec.counts(active_dim)
    correction_if_no_diagonal = spec.D if (not num_lmc and not num_indep) else 0
    if tot_rank + spec.D < spec.D**2 + correction_if_no_diagonal:
        return "slfm"
    return "bt"


@struct.dataclass
class GridData:
    """Parameter-independent grid artifacts for one group.

    A pytree: pass it through jit boundaries as an ARGUMENT, never
    capture it in a closure — large closure-captured arrays become HLO
    constants embedded in (and recompiled with) every program.
    ``plan`` is static metadata and participates in the jit cache key.
    """

    plan: GridPlan = struct.field(static=True)
    dists: Any = None  # (m,) flattened BTTB first-row distances
    interp: Interp = None  # W for the training inputs, (n, D*m)
    idx_map: Any = None  # (m, m) int32 BTTB index map ('dense' mode)
    W_blocks: Any = None  # per-output dense (n_d, m) blocks ('dense')
    WtW: Any = None  # (D, m, m) stacked per-output grams W_d^T W_d
    # ('dense'; feeds the device Woodbury capacitance assembly)
    coarse: Any = None  # for non-dense groups: a dense-mode GridData on
    # a COARSENED copy of the same grid (D*m_c <= DENSE_MAX_GRID) — the
    # geometry of the f32 Woodbury PRECONDITIONER for large-grid solves.
    # Host-side only; the model strips it from the fine grid_data and
    # converts it once via precond_dense_f32.


def coarse_sizes(sizes, D, cap=None):
    """Per-dim sizes of the COARSENED preconditioner grid: the largest
    proportional shrink of ``sizes`` with D * prod(out) <= ``cap``
    (default DENSE_MAX_GRID) and every dim >= 4 (the cubic-interp
    minimum)."""
    cap = cap or DENSE_MAX_GRID
    sizes = tuple(int(s) for s in sizes)
    P = len(sizes)
    budget = max(cap // max(D, 1), 4**P)
    if int(np.prod(sizes)) <= budget:
        return sizes
    factor = (budget / float(np.prod(sizes))) ** (1.0 / P)
    out = [max(4, int(np.floor(s * factor))) for s in sizes]
    while int(np.prod(out)) > budget:
        i = int(np.argmax(out))
        if out[i] <= 4:
            break
        out[i] -= 1
    return tuple(out)


def _dense_artifacts(Xs_active, axes, sizes):
    """(idx_map, W_blocks, WtW) for a dense-mode group."""
    idx_map = bttb_ops.bttb_index_map(sizes)
    W_blocks = tuple(interp_output_blocks(Xs_active, axes))
    wtw = np.stack([b.T @ b for b in W_blocks])
    return idx_map, W_blocks, wtw


def make_grids(spec: LMCKernelSpec, Xs, lo=None, hi=None, m=None,
               rep=None, mode="auto"):
    """Build grids/distances/interpolants per active-dim group (parity:
    InterpolatedLLGP._generate_grids, interpolated_llgp.py:415-443).

    ``Xs``: list of per-output (n_i, P) design matrices.
    ``mode``: 'fft' | 'dense' | 'tiled' | 'auto' (dense when
    D*m <= DENSE_MAX_GRID, else fft). Non-dense groups additionally get
    a COARSENED dense-mode twin (``GridData.coarse``) — same data, same
    kernels, grid proportionally shrunk under the dense cap — whose f32
    Woodbury factorization preconditions the large-grid solves.
    Returns ``(grid_data, axes)``: a list of :class:`GridData` pytrees
    and the per-group list of per-dim numpy grid axes (host-side, used
    to interpolate test inputs at prediction time).
    """
    if mode not in ("auto", "fft", "dense", "tiled"):
        raise ValueError("unknown grid mode %r" % (mode,))

    def _sub(v, active_dim):
        if v is None:
            return None
        v = np.asarray(v)
        if v.ndim == 0:
            assert len(active_dim) == 1
            return v.reshape(1)
        return v[list(active_dim)]

    out = []
    all_axes = []
    for active_dim, kidxs in spec.active_dims.items():
        Xs_active = [np.asarray(X)[:, list(active_dim)] for X in Xs]
        axes = autogrid(
            Xs_active, _sub(lo, active_dim), _sub(hi, active_dim),
            _sub(m, active_dim),
        )
        grid = cartesian_product(*axes)
        dists = np.linalg.norm(grid - grid[0], axis=-1)
        sizes = tuple(len(a) for a in axes)
        interp = multi_interpolant(Xs_active, axes)
        m_tot = int(np.prod(sizes))
        group_mode = mode
        if mode == "auto":
            group_mode = (
                "dense" if spec.D * m_tot <= DENSE_MAX_GRID else "fft"
            )
        plan = GridPlan(
            active_dim=tuple(active_dim),
            kidxs=tuple(kidxs),
            rep=rep or choose_rep(spec, active_dim),
            sizes=sizes,
            mode=group_mode,
        )
        # Everything here stays HOST numpy; the model moves these to
        # the device once, at its model dtype.
        idx_map = None
        W_blocks = None
        wtw = None
        coarse = None
        if group_mode == "dense":
            idx_map, W_blocks, wtw = _dense_artifacts(
                Xs_active, axes, sizes
            )
        else:
            n_total = sum(len(X) for X in Xs_active)
            if n_total * m_tot <= W_BLOCKS_MAX_ELEMS:
                W_blocks = tuple(
                    interp_output_blocks(Xs_active, axes)
                )
            # preconditioner twin: the exact fine geometry when
            # D*m fits under PRECOND_MAX_GRID (f32-floor factor
            # quality), else proportionally shrunken sizes
            c_sizes = coarse_sizes(sizes, spec.D, cap=PRECOND_MAX_GRID)
            if c_sizes == sizes:
                c_axes = axes
                c_dists = dists
                c_interp = interp
            else:
                c_axes = [
                    np.linspace(a[0], a[-1], s)
                    for a, s in zip(axes, c_sizes)
                ]
                c_grid = cartesian_product(*c_axes)
                c_dists = np.linalg.norm(c_grid - c_grid[0], axis=-1)
                c_interp = multi_interpolant(Xs_active, c_axes)
            c_idx, c_blocks, c_wtw = _dense_artifacts(
                Xs_active, c_axes, c_sizes
            )
            coarse = GridData(
                plan=GridPlan(
                    active_dim=tuple(active_dim), kidxs=tuple(kidxs),
                    rep=plan.rep, sizes=c_sizes, mode="dense",
                ),
                dists=c_dists,
                interp=c_interp,
                idx_map=c_idx, W_blocks=c_blocks, WtW=c_wtw,
            )
        out.append(
            GridData(
                plan=plan, dists=dists, interp=interp,
                idx_map=idx_map, W_blocks=W_blocks, WtW=wtw,
                coarse=coarse,
            )
        )
        all_axes.append(axes)
    return out, all_axes


# --------------------------------------------------------------------------
# Jit-side parameter-dependent state + fused matvec.
# --------------------------------------------------------------------------


@struct.dataclass
class GroupState:
    """Fourier-space state of one active-dim group's K_UU term."""

    sizes: Tuple[int, ...] = struct.field(static=True)
    rep: str = struct.field(static=True)
    mode: str = struct.field(static=True, default="fft")
    grid_shard: Any = struct.field(static=True, default=None)
    interp: Interp = None
    W_blocks: Any = None  # per-output dense (n_d, m) interp blocks
    grid_tops: Any = None  # (Qg, m) kernels on grid (kept for prediction)
    # 'dense' mode: the materialized grid kernel
    KUU_dense: Optional[Any] = None  # (D*m, D*m)
    # 'sum'
    B: Optional[Any] = None  # (Qg, D, D)
    That: Optional[Any] = None  # (Qg, F) complex
    # 'bt'
    BThat: Optional[Any] = None  # (D, D, F) complex
    # 'slfm'
    A: Optional[Any] = None  # (D, R_tot)
    That_rep: Optional[Any] = None  # (R_tot, F) complex
    diag_That: Optional[Any] = None  # (D, F) complex

    @property
    def D(self):
        return self.interp.ncols // int(np.prod(self.sizes))

    def fourier_shape(self):
        ext = bttb_ops.extension_sizes(self.sizes)
        return ext[:-1] + (bttb_ops.rfft_len(ext),)

    def grid_matvec(self, u):
        """K_UU u for this group: u (..., D*m) -> (..., D*m)."""
        if self.mode == "dense":
            return jnp.einsum(
                "ij,...j->...i", self.KUU_dense, u, precision=_HI
            )
        if self.mode == "tiled":
            sizes = self.sizes
            m = int(np.prod(sizes))
            d = self.D
            x = u.reshape(u.shape[:-1] + (d, m))
            out = bttb_ops.bttb_tiled_kuu_matvec(
                self.grid_tops, self.B, x, sizes
            )
            return out.reshape(u.shape[:-1] + (d * m,))
        sizes = self.sizes
        m = int(np.prod(sizes))
        d = self.D
        batch = u.shape[:-1]
        fsh = self.fourier_shape()
        F = int(np.prod(fsh))

        x = u.reshape(batch + (d, m))
        vhat = bttb_ops.operand_fft(x, sizes)  # (..., d, *fsh)
        vf = vhat.reshape(batch + (d, F))
        vf = _shard_last(vf, self.grid_shard)

        if self.rep == "sum":
            g = jnp.einsum(
                "qde,qf,...ef->...df", self.B, self.That, vf,
                precision=_HI,
            )
        elif self.rep == "bt":
            g = jnp.einsum("def,...ef->...df", self.BThat, vf,
                           precision=_HI)
        elif self.rep == "slfm":
            proj = jnp.einsum("dr,...df->...rf", self.A, vf,
                              precision=_HI)
            proj = proj * self.That_rep
            g = jnp.einsum("dr,...rf->...df", self.A, proj,
                           precision=_HI)
            g = g + self.diag_That * vf
        else:  # pragma: no cover
            raise AssertionError(self.rep)

        g = _shard_last(g, self.grid_shard)
        ghat = g.reshape(batch + (d,) + fsh)
        out = bttb_ops.operand_ifft(ghat, sizes)  # (..., d, m)
        return out.reshape(batch + (d * m,))

    def matvec(self, x):
        """Full SKI term W K_UU W^T x: (..., n) -> (..., n)."""
        if self.W_blocks is not None:
            return self._matvec_blocks(x)
        u = self.interp.rmatvec(x)
        return self.interp.matvec(self.grid_matvec(u))

    def _matvec_blocks(self, x):
        """All-matmul SKI matvec via per-output dense interp blocks:
        W^T and W become dense matmuls instead of gather/scatter."""
        splits = np.cumsum([b.shape[0] for b in self.W_blocks])[:-1]
        xs = jnp.split(x, splits, axis=-1)
        u = jnp.concatenate(
            [
                jnp.einsum("nm,...n->...m", b, xd, precision=_HI)
                for b, xd in zip(self.W_blocks, xs)
            ],
            axis=-1,
        )  # (..., D*m) in output-major layout, matching interp columns
        g = self.grid_matvec(u)
        m = self.W_blocks[0].shape[1]
        outs = [
            jnp.einsum(
                "nm,...m->...n",
                b,
                g[..., d * m : (d + 1) * m],
                precision=_HI,
            )
            for d, b in enumerate(self.W_blocks)
        ]
        return jnp.concatenate(outs, axis=-1)


def _dense_f32_one(gd):
    assert gd.plan.mode == "dense", gd.plan
    return gd.replace(
        idx_map=jnp.asarray(gd.idx_map),
        dists=jnp.asarray(gd.dists, dtype=jnp.float32),
        interp=gd.interp.replace(
            weights=jnp.asarray(gd.interp.weights, dtype=jnp.float32)
        ),
        W_blocks=tuple(
            jnp.asarray(b, dtype=jnp.float32) for b in gd.W_blocks
        ),
        WtW=jnp.asarray(gd.WtW, dtype=jnp.float32),
        coarse=None,
    )


def to_dense_f32(grid_data):
    """Float32 copies of the dense-mode grid artifacts — the inputs to
    the per-step float32 direct Woodbury factorization (woodbury.py).
    Index maps are shared (ints); everything float is downcast."""
    return tuple(_dense_f32_one(gd) for gd in grid_data)


def precond_dense_f32(grid_data):
    """Per-group float32 DENSE artifacts for the Woodbury
    preconditioner factor: a dense-mode group contributes itself (the
    factor is then EXACT at f32), a non-dense group contributes its
    coarsened twin (``GridData.coarse`` — the factor is then a coarse
    approximation whose PCG refinement against the exact operator still
    certifies true residuals). Input is the raw host-side make_grids
    output."""
    out = []
    for gd in grid_data:
        if gd.plan.mode == "dense":
            out.append(_dense_f32_one(gd))
        else:
            assert gd.coarse is not None, gd.plan
            out.append(_dense_f32_one(gd.coarse))
    return tuple(out)


def fine_fft_f32(grid_data):
    """Float32 fft-mode copies of the FINE grid artifacts — the cheap
    inner operator of mixed-precision solves (inner Krylov cycles at
    f32 FFT speed; the outer refinement recomputes true residuals
    through the model-dtype 'tiled'/'dense' operator). Dense-mode
    groups stay dense (their matmul matvec is already the f32 path)."""
    import dataclasses as _dc

    out = []
    for gd in grid_data:
        if gd.plan.mode == "dense":
            out.append(_dense_f32_one(gd))
        else:
            out.append(
                gd.replace(
                    plan=_dc.replace(gd.plan, mode="fft"),
                    dists=jnp.asarray(gd.dists, dtype=jnp.float32),
                    interp=gd.interp.replace(
                        weights=jnp.asarray(
                            gd.interp.weights, dtype=jnp.float32
                        )
                    ),
                    W_blocks=(
                        None
                        if gd.W_blocks is None
                        else tuple(
                            jnp.asarray(b, dtype=jnp.float32)
                            for b in gd.W_blocks
                        )
                    ),
                    coarse=None,
                )
            )
    return tuple(out)


def build_group_state(
    spec: LMCKernelSpec, raw_params, plan: GridPlan, dists, interp: Interp,
    idx_map=None, w_blocks=None,
) -> GroupState:
    """Evaluate kernels on the grid and assemble the contraction state
    for one group (parameter-dependent; runs under jit once per
    optimization step). 'fft' mode precomputes the Fourier symbol;
    'dense' mode materializes K_UU = sum_q B_q (x) T_q as one (Dm, Dm)
    matrix via the BTTB index-map gather — dense-matmul matvecs."""
    kidxs = plan.kidxs
    sizes = plan.sizes
    tops = spec.eval_kernels_stacked(raw_params, dists, kidxs)  # (Qg, m)

    if plan.mode == "dense":
        T = tops[:, idx_map]  # (Qg, m, m) dense BTTB blocks
        B = spec.coreg_mats(raw_params, kidxs)  # (Qg, D, D)
        KUU = jnp.einsum("qde,qij->diej", B, T, precision=_HI)
        dm = B.shape[1] * T.shape[1]
        return GroupState(
            sizes=sizes, rep=plan.rep, mode="dense", interp=interp,
            grid_shard=plan.grid_shard,
            W_blocks=w_blocks, grid_tops=tops,
            KUU_dense=_shard_rows(KUU.reshape(dm, dm), plan.grid_shard),
        )

    if plan.mode == "tiled":
        # exact matvec from first rows, any dtype; no materialization
        return GroupState(
            sizes=sizes, rep=plan.rep, mode="tiled", interp=interp,
            grid_shard=plan.grid_shard,
            W_blocks=w_blocks, grid_tops=tops,
            B=spec.coreg_mats(raw_params, kidxs),
        )

    that = bttb_ops.bttb_fft(tops, sizes).reshape(len(kidxs), -1)  # (Qg, F)
    that = _shard_last(that, plan.grid_shard)

    kwargs = dict(
        sizes=sizes, rep=plan.rep, mode="fft", interp=interp,
        grid_shard=plan.grid_shard,
        grid_tops=tops,
        W_blocks=w_blocks,
    )
    if plan.rep == "sum":
        kwargs["B"] = spec.coreg_mats(raw_params, kidxs)
    elif plan.rep == "bt":
        B = spec.coreg_mats(raw_params, kidxs)
        kwargs["BThat"] = jnp.einsum("qde,qf->def", B, that,
                                     precision=_HI)
    elif plan.rep == "slfm":
        non_indep = spec.non_indep_idxs(kidxs)
        pos_of = {q: i for i, q in enumerate(kidxs)}
        if non_indep:
            a_blocks = [spec.coreg_vec(raw_params, q) for q in non_indep]
            A_star = jnp.concatenate(a_blocks, axis=0).T  # (D, R_tot)
            reps = []
            for q in non_indep:
                reps.extend([pos_of[q]] * spec.ranks[q])
            That_rep = that[jnp.asarray(np.asarray(reps, np.int32))]
        else:
            A_star = jnp.zeros((spec.D, 1), dtype=tops.dtype)
            That_rep = jnp.zeros((1, that.shape[1]), dtype=that.dtype)
        kappa = jnp.stack(
            [spec.coreg_diag(raw_params, q) for q in kidxs]
        )  # (Qg, D)
        kwargs["A"] = A_star
        kwargs["That_rep"] = That_rep
        kwargs["diag_That"] = jnp.einsum("qd,qf->df", kappa, that,
                                         precision=_HI)
    else:  # pragma: no cover
        raise AssertionError(plan.rep)
    kwargs["That"] = that
    return GroupState(**kwargs)


@struct.dataclass
class KSKI(LinearOperator):
    """The full SKI LMC covariance operator over the stacked data vector:

        K = sum_groups W_g K_UU_g W_g^T + diag(noise per point)

    (parity: gen_grid_kernel's SumMatrix-of-GridKernels + noise Diag,
    runlmc/lmc/grid_kernel.py:49-74). A differentiable pytree: feed it to
    the batched solvers, autodiff through its matvec for gradients.
    """

    groups: Any  # tuple of GroupState
    noise_n: Any  # (n,) per-data-point noise

    @property
    def shape(self):
        n = self.noise_n.shape[0]
        return (n, n)

    def matvec(self, x):
        out = self.noise_n * x
        for g in self.groups:
            out = out + g.matvec(x)
        return out



def build_kski(spec: LMCKernelSpec, raw_params, grid_data, lens) -> KSKI:
    """Assemble the full covariance operator state from raw parameters
    (runs under jit; rebuilt each optimization step — parity with
    parameters_changed -> gen_grid_kernel, interpolated_llgp.py:192-200)."""
    groups = tuple(
        build_group_state(
            spec, raw_params, gd.plan, gd.dists, gd.interp, gd.idx_map,
            gd.W_blocks,
        )
        for gd in grid_data
    )
    noise = spec.noise(raw_params)
    noise_n = jnp.repeat(
        noise, jnp.asarray(np.asarray(lens)), total_repeat_length=int(sum(lens))
    )
    return KSKI(groups=groups, noise_n=noise_n)
