"""Batched FFT circulant-embedding engine for symmetric (block-)Toeplitz
matrices — THE hot kernel of the framework.

A symmetric P-level block-Toeplitz-of-Toeplitz-blocks (BTTB) matrix over a
P-dimensional grid with per-axis sizes ``sizes`` is fully described by its
first row ``top`` (length ``prod(sizes)``). Its matvec embeds into a
P-dimensional circulant of per-axis size ``next_pow2(2 * n_p)`` and runs in
O(m log m) via real FFTs (behavioral parity: reference
runlmc/linalg/bttb.py:107-148; the reference computes one numpy
``rfftn``/``irfftn`` per matvec per operator).

Design differences from the reference:

- Everything is expressed on *batched* leading axes. One call transforms a
  whole stack of vectors (probes, RHS, outputs D, latent kernels Q) in a
  single fused XLA FFT, instead of the reference's per-operator Python
  loops.
- The Fourier transform of the symbol (``bttb_fft``) and of the operand are
  exposed separately, so the LMC grid kernel can do its coregionalization
  contraction *in Fourier space* (see runlmc_tpu/lmc/grid.py): for a sum of
  Kronecker products sum_q B_q (x) T_q, one forward FFT of the operand and
  one inverse FFT of the contracted result suffice regardless of Q.
- All shapes are static; ``jnp.fft`` lowers to XLA's native FFT.

Everything here is differentiable w.r.t. ``top`` (used by the autodiff
gradient path).
"""

from functools import partial

import jax.numpy as jnp
import numpy as np


def next_pow2(x):
    """Smallest power of two >= x (python int)."""
    return 1 << (int(x) - 1).bit_length()


def extension_sizes(sizes):
    """Per-axis circulant embedding sizes: next_pow2(2 * n_p).

    Power-of-two padding matches the reference's choice
    (runlmc/linalg/bttb.py:16-19,112) and keeps XLA FFT sizes friendly.
    """
    return tuple(next_pow2(2 * int(s)) for s in sizes)


def rfft_len(ext_sizes):
    """Length of the last axis after rfftn."""
    return ext_sizes[-1] // 2 + 1


def cyclic_extend(top, sizes):
    """Symmetrically extend a (batched) first row into its circulant embedding.

    ``top``: (..., prod(sizes)). Returns (..., *ext_sizes) where along each
    grid axis the layout is ``[t_0..t_{n-1}, 0...0, t_{n-1}..t_1]`` — the
    standard symmetric circulant embedding (reference:
    runlmc/linalg/bttb.py:110-120 does this with in-place slice surgery; we
    build it functionally with flips+concat so it stays differentiable).
    """
    sizes = tuple(int(s) for s in sizes)
    ext = extension_sizes(sizes)
    batch = top.shape[:-1]
    x = top.reshape(batch + sizes)
    for axis_off, (n, m) in enumerate(zip(sizes, ext)):
        axis = len(batch) + axis_off
        mirror = jnp.flip(
            jax_slice(x, axis, 1, n), axis=axis
        )  # t_{n-1} .. t_1
        pad_width = m - n - (n - 1)
        pad_shape = list(x.shape)
        pad_shape[axis] = pad_width
        zeros = jnp.zeros(pad_shape, dtype=top.dtype)
        x = jnp.concatenate([x, zeros, mirror], axis=axis)
    return x


def jax_slice(x, axis, start, stop):
    idx = [slice(None)] * x.ndim
    idx[axis] = slice(start, stop)
    return x[tuple(idx)]


def bttb_fft(top, sizes):
    """rfftn of the circulant embedding of (batched) ``top``.

    Returns complex array of shape (..., *ext_sizes[:-1], rfft_len).
    This is the operator's Fourier "symbol"; precompute it once per
    parameter update and reuse it for every matvec.
    """
    sizes = tuple(int(s) for s in sizes)
    ext = cyclic_extend(top, sizes)
    axes = tuple(range(ext.ndim - len(sizes), ext.ndim))
    return jnp.fft.rfftn(ext, axes=axes)


def operand_fft(v, sizes):
    """Zero-padded rfftn of a (batched) grid vector ``v``: (..., prod(sizes))
    -> (..., *fourier_shape)."""
    sizes = tuple(int(s) for s in sizes)
    ext = extension_sizes(sizes)
    batch = v.shape[:-1]
    x = v.reshape(batch + sizes)
    axes = tuple(range(len(batch), len(batch) + len(sizes)))
    return jnp.fft.rfftn(x, s=ext, axes=axes)


def operand_ifft(vhat, sizes):
    """Inverse of :func:`operand_fft` followed by the subrectangle crop:
    (..., *fourier_shape) -> (..., prod(sizes))."""
    sizes = tuple(int(s) for s in sizes)
    ext = extension_sizes(sizes)
    nbatch = vhat.ndim - len(sizes)
    axes = tuple(range(nbatch, vhat.ndim))
    full = jnp.fft.irfftn(vhat, s=ext, axes=axes)
    crop = tuple([slice(None)] * nbatch + [slice(0, n) for n in sizes])
    sub = full[crop]
    return sub.reshape(vhat.shape[:nbatch] + (int(np.prod(sizes)),))


def bttb_matvec(symbol_fft, v, sizes):
    """Matvec of a symmetric BTTB matrix given its Fourier symbol.

    ``symbol_fft``: (..., *fourier_shape) from :func:`bttb_fft`.
    ``v``: (..., prod(sizes)). Leading batch axes broadcast against each
    other; a single call can therefore apply Q stacked operators to B
    stacked vectors at once.
    """
    vhat = operand_fft(v, sizes)
    return operand_ifft(symbol_fft * vhat, sizes)


def bttb_matvec_from_top(top, v, sizes):
    """One-shot matvec from the first row (convenience / tests)."""
    return bttb_matvec(bttb_fft(top, sizes), v, sizes)


def bttb_dense(top, sizes):
    """Densify a symmetric BTTB matrix (host-side oracle for tests; parity:
    reference runlmc/linalg/bttb.py:122-142 `as_numpy`).

    Built by applying the FFT matvec to the identity — O(m^2 log m), test
    use only.
    """
    m = int(np.prod(tuple(int(s) for s in sizes)))
    eye = jnp.eye(m, dtype=top.dtype)
    return bttb_matvec_from_top(top, eye, sizes).T


def bttb_index_map(sizes):
    """(m, m) int32 map from (i, j) to the flattened first-row index of a
    symmetric BTTB matrix: entry (i, j) of the dense matrix equals
    ``top[idx_map[i, j]]`` where the flat offset is
    sum_d |i_d - j_d| * stride_d.

    Host-side, parameter-independent; precompute once per grid. Enables
    the 'dense' grid mode: materialize the (Dm, Dm) grid kernel by a
    gather and run matvecs as dense matmuls instead of via FFT, used
    whenever the grid is small enough.
    """
    sizes = tuple(int(s) for s in sizes)
    m = int(np.prod(sizes))
    idx = np.zeros((m, m), dtype=np.int64)
    stride = m
    for n in sizes:
        stride //= n
        c = (np.arange(m) // stride) % n  # this dim's coordinate
        idx += np.abs(c[:, None] - c[None, :]) * stride
    return idx.astype(np.int32)


def bttb_tiled_kuu_matvec(tops, B, x, sizes, tile=None):
    """EXACT LMC grid-kernel matvec computed tile-by-tile from first
    rows: applies K_UU = sum_q B_q (x) T_q to ``x`` without
    materializing the (Dm, Dm) matrix, the (m, m) index map, or any
    FFT — O(Q m^2 D) matmul work, O(tile * m) memory, ANY dtype.

    The operator of the explicit ``grid_mode='tiled'``, and an
    FFT-free reference for the fft-mode grid matvec: the
    mixed-precision refinement solvers can run their inner Krylov
    cycles through the f32 Fourier path and pay ONE of these exact
    matvecs per outer cycle to compute the true residual. Fully
    differentiable w.r.t. ``tops`` and ``B`` (gather + einsum under
    ``lax.map``).

    :param tops: (Q, m) kernels evaluated on the grid's first row.
    :param B: (Q, D, D) coregionalization matrices.
    :param x: (..., D, m) operand (leading axes batch).
    :param tile: row-tile length (default: adaptive, <= 512).
    :returns: (..., D, m).
    """
    import jax
    from jax import lax

    sizes = tuple(int(s) for s in sizes)
    m = int(np.prod(sizes))
    if tile is None:
        # bound the gathered (Q, tile, m) block to ~2^24 elements
        q = int(tops.shape[0])
        tile = max(64, min(512, (1 << 24) // max(q * m, 1)))
    tile = min(tile, m)
    n_tiles = -(-m // tile)
    mp = n_tiles * tile

    # per-axis coordinates of every flattened grid index (host-side,
    # parameter-independent, tiny: P * m int32)
    coords = []
    strides = []
    stride = m
    for n_ in sizes:
        stride //= n_
        coords.append(((np.arange(m) // stride) % n_).astype(np.int32))
        strides.append(stride)
    coords_j = jnp.asarray(np.asarray(coords, np.int32))  # (P, m)
    coords_pad = jnp.asarray(
        np.pad(np.asarray(coords, np.int32), ((0, 0), (0, mp - m)),
               mode="edge")
    )  # (P, mp) — padded rows recompute a valid row; outputs cropped
    strides_a = jnp.asarray(np.asarray(strides, np.int32))
    hi = jax.lax.Precision.HIGHEST

    def body(s):
        ci = lax.dynamic_slice(
            coords_pad, (jnp.zeros((), s.dtype), s),
            (coords_pad.shape[0], tile),
        )  # (P, tile)
        # flattened first-row offset: sum_d |i_d - j_d| * stride_d
        diff = jnp.abs(ci[:, :, None] - coords_j[:, None, :])
        idx = jnp.sum(diff * strides_a[:, None, None], axis=0)
        T = jnp.take(tops, idx, axis=1)  # (Q, tile, m)
        V = jnp.einsum("qtm,...em->...qte", T, x, precision=hi)
        return jnp.einsum("qde,...qte->...dt", B, V, precision=hi)

    tiles = lax.map(body, jnp.arange(n_tiles, dtype=jnp.int32) * tile)
    out = jnp.moveaxis(tiles, 0, -2)  # (..., D, n_tiles, tile)
    return out.reshape(x.shape[:-1] + (mp,))[..., :m]


def toeplitz_eig_upper_bound(top):
    """Gershgorin upper eigenvalue bound for a symmetric Toeplitz matrix:
    max_i row_i(|T|) computed in O(n) with prefix sums (behavior parity:
    reference runlmc/linalg/toeplitz.py:69-85)."""
    a = np.abs(np.asarray(top))
    prefix = np.cumsum(a)
    n = len(a)
    rows = prefix + prefix[::-1] - a[0]
    return float(rows.max()) if n else 0.0


def bttb_eig_upper_bound(top, sizes):
    """Cheap Gershgorin-style upper bound for a symmetric BTTB matrix.

    Every row's absolute sum is bounded by the absolute sum over the full
    signed-offset lattice, i.e. at most 2^P * sum|top| (each |offset|
    pattern appears for up to 2^P sign patterns). Loose but safe; used only
    for conditioning diagnostics.
    """
    p = len(tuple(sizes))
    return float((2**p) * np.abs(np.asarray(top)).sum())
