"""Frozen dataclasses registered as JAX pytrees.

``@dataclass`` makes a frozen dataclass whose fields are pytree leaves
(traced, differentiable) unless declared with ``field(static=True)``:
static fields live in the tree definition, so they take part in the jit
cache key and must be hashable. Instances get a ``.replace(**updates)``
method (``dataclasses.replace``).
"""

import dataclasses

import jax


def field(*, static=False, **kwargs):
    """A dataclass field; ``static=True`` keeps it out of the leaves."""
    metadata = dict(kwargs.pop("metadata", None) or {}, static=static)
    return dataclasses.field(metadata=metadata, **kwargs)


def _replace(self, **updates):
    return dataclasses.replace(self, **updates)


def dataclass(cls):
    """Decorate ``cls`` as a frozen dataclass and register it as a
    pytree (see the module docstring)."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = dataclasses.fields(cls)
    jax.tree_util.register_dataclass(
        cls,
        data_fields=[f.name for f in fields if not f.metadata.get("static")],
        meta_fields=[f.name for f in fields if f.metadata.get("static")],
    )
    cls.replace = _replace
    return cls
