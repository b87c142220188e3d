"""The pytree dataclass helper (runlmc_tpu.utils.struct)."""

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from runlmc_tpu.utils import struct


@struct.dataclass
class _Pair:
    scale: Any
    offset: Any = None
    label: str = struct.field(static=True, default="a")


def test_flatten_unflatten_round_trip():
    p = _Pair(scale=jnp.arange(3.0), offset=jnp.ones(2), label="x")
    leaves, treedef = jax.tree_util.tree_flatten(p)
    assert len(leaves) == 2  # the static label is not a leaf
    q = jax.tree_util.tree_unflatten(treedef, leaves)
    assert q.label == "x"
    np.testing.assert_array_equal(q.scale, p.scale)
    np.testing.assert_array_equal(q.offset, p.offset)
    doubled = jax.tree.map(lambda a: 2 * a, p)
    np.testing.assert_array_equal(doubled.scale, 2 * p.scale)
    assert doubled.label == "x"
    g = jax.grad(lambda t: jnp.sum(t.scale * t.offset[0]))(p)
    np.testing.assert_array_equal(g.scale, jnp.ones(3))


def test_static_field_is_part_of_jit_cache_key():
    traces = []

    @jax.jit
    def f(p):
        traces.append(p.label)  # a Python str inside the trace
        return p.scale * (2.0 if p.label == "b" else 1.0)

    a = _Pair(scale=jnp.ones(2), label="a")
    np.testing.assert_array_equal(f(a), jnp.ones(2))
    f(a.replace(scale=jnp.zeros(2)))  # same static value: cache hit
    assert traces == ["a"]
    np.testing.assert_array_equal(f(a.replace(label="b")), 2 * jnp.ones(2))
    assert traces == ["a", "b"]


def test_replace_returns_new_frozen_instance():
    p = _Pair(scale=1.0)
    q = p.replace(offset=2.0, label="c")
    assert (p.offset, p.label) == (None, "a")
    assert (q.scale, q.offset, q.label) == (1.0, 2.0, "c")
    with pytest.raises(dataclasses.FrozenInstanceError):
        q.scale = 3.0
