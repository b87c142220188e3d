"""Batched Krylov solver tests against dense solves."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from runlmc_tpu.ops import solvers
from tests.utils import bttb_dense_oracle, poor_cond_toep, rand_pd


def _mv(dense):
    a = jnp.asarray(dense)
    return lambda v: jnp.einsum("ij,...j->...i", a, v)


@pytest.mark.parametrize("method", ["minres", "cg"])
def test_solve_spd_batched(rng, method):
    n, B = 40, 6
    a = rand_pd(rng, n)
    b = rng.standard_normal((B, n))
    res = solvers.solve(_mv(a), jnp.asarray(b), method=method, tol=1e-8)
    expected = np.linalg.solve(a, b.T).T
    np.testing.assert_allclose(res.x, expected, rtol=1e-5, atol=1e-6)
    assert bool(res.converged.all())
    assert np.all(res.error < 1e-7)


def test_minres_indefinite(rng):
    # MINRES handles symmetric indefinite systems (CG cannot).
    n = 30
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    eigs = np.concatenate([np.linspace(1, 5, n - 5), -np.linspace(1, 2, 5)])
    a = (q * eigs) @ q.T
    b = rng.standard_normal((2, n))
    res = solvers.batched_minres(_mv(a), jnp.asarray(b), tol=1e-8)
    np.testing.assert_allclose(res.x, np.linalg.solve(a, b.T).T,
                               rtol=1e-5, atol=1e-6)


def test_poorly_conditioned_toeplitz(rng):
    n = 64
    top = poor_cond_toep(rng, n)
    a = bttb_dense_oracle(top, (n,)) + 1e-4 * np.eye(n)
    b = rng.standard_normal((3, n))
    res = solvers.batched_minres(_mv(a), jnp.asarray(b), tol=1e-6, maxiter=4 * n)
    assert np.all(res.error < 1e-5)


def test_zero_rhs(rng):
    a = rand_pd(rng, 10)
    b = np.zeros((2, 10))
    b[1] = rng.standard_normal(10)
    res = solvers.batched_minres(_mv(a), jnp.asarray(b), tol=1e-8)
    np.testing.assert_allclose(res.x[0], 0.0, atol=1e-12)
    np.testing.assert_allclose(res.x[1], np.linalg.solve(a, b[1]),
                               rtol=1e-5, atol=1e-7)


def test_maxiter_caps_iterations(rng):
    a = rand_pd(rng, 50)
    b = rng.standard_normal((2, 50))
    res = solvers.batched_minres(_mv(a), jnp.asarray(b), tol=1e-14, maxiter=3)
    assert int(res.iterations.max()) == 3
    assert not bool(res.converged.all())


def test_single_vector_rhs(rng):
    a = rand_pd(rng, 12)
    b = rng.standard_normal(12)
    res = solvers.solve(_mv(a), jnp.asarray(b), tol=1e-9)
    np.testing.assert_allclose(res.x[0], np.linalg.solve(a, b),
                               rtol=1e-6, atol=1e-8)


def test_cg_with_preconditioner(rng):
    n = 40
    a = rand_pd(rng, n)
    d = 1.0 / np.diag(a)
    b = rng.standard_normal((2, n))
    res = solvers.batched_cg(
        _mv(a), jnp.asarray(b), tol=1e-8, precond=lambda v: jnp.asarray(d) * v
    )
    np.testing.assert_allclose(res.x, np.linalg.solve(a, b.T).T,
                               rtol=1e-5, atol=1e-6)


def test_solver_jits_and_iteration_counts(rng):
    n = 24
    a = rand_pd(rng, n)
    b = rng.standard_normal((4, n))

    @jax.jit
    def run(b):
        return solvers.batched_minres(_mv(a), b, tol=1e-8)

    res = run(jnp.asarray(b))
    assert res.x.shape == (4, n)
    assert np.all(np.asarray(res.iterations) <= n)


def test_sharded_rhs_batch(rng):
    """The solve batch shards over a device mesh — the analog of the
    reference's multiprocessing pool (SURVEY.md section 2.9)."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    n, B = 32, 8
    a = rand_pd(rng, n)
    mesh = Mesh(np.array(jax.devices()), ("rhs",))
    sharding = NamedSharding(mesh, P("rhs", None))
    b = jax.device_put(jnp.asarray(rng.standard_normal((B, n))), sharding)

    @jax.jit
    def run(b):
        return solvers.batched_minres(_mv(a), b, tol=1e-8)

    res = run(b)
    np.testing.assert_allclose(
        res.x, np.linalg.solve(a, np.asarray(b).T).T, rtol=1e-5, atol=1e-6
    )
