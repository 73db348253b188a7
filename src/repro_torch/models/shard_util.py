"""Sharding constraints -- port of ``repro.models.shard_util``.

The reference's model code calls ``constrain(x, "model", "data", ...)``,
which applies a sharding constraint when it is traced under a JAX mesh with
those axes (its pod dry run) and is the identity otherwise.  The port runs
on one card and has no mesh (``models/moe.py``): ``current_mesh`` is always
``None`` and ``constrain`` always the identity, kept so that code written
against the reference's names reads the same here.
"""
from __future__ import annotations


def current_mesh():
    """The active device mesh: one card has none."""
    return None


def constrain(x, *spec_entries):
    """The reference's sharding constraint off a mesh: ``x`` itself."""
    return x
