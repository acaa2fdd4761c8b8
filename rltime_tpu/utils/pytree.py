"""Immutable state records that jit, donation and tree maps see as pytrees."""
from __future__ import annotations

import dataclasses

import jax


class PyTreeNode:
    """Base class: each subclass becomes a frozen dataclass whose fields
    are all pytree children, registered with JAX, with `.replace`.

        class TrainState(PyTreeNode):
            params: Any
            key: jnp.ndarray

        state = state.replace(key=new_key)
    """

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        dataclasses.dataclass(frozen=True)(cls)
        jax.tree_util.register_dataclass(
            cls, data_fields=[f.name for f in dataclasses.fields(cls)],
            meta_fields=[])

    def replace(self, **changes):
        """A copy with the named fields replaced."""
        return dataclasses.replace(self, **changes)
