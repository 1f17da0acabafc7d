"""The partition-rule table (``deeprest_tpu/parallel/sharding.py``): ONE
ordered regex table places every TrainState leaf on the mesh.

Every QuantileGRU parameter carries a leading expert axis
(models/qrnn.py), so the expert axis is uniformly "axis 0 on ``expert``";
the ``model`` axis shards the call-path feature dimension F where it
appears (the mask's output and the layer-0 GRU input projections, the two
places that grow with the endpoint vocabulary); everything else is
replicated.  JAX hands the table to GSPMD, which inserts the collectives;
the port runs one rank a device, so a rank holds only its *box* of each
leaf (:func:`rank_box`, :func:`shard_params`) and the model runs the
collectives itself (``parallel/collectives.py``).

A spec is a plain tuple with one entry per dimension: an axis name or
None (replicated along it); ``()`` replicates the whole leaf.  The table
is matched against "/"-joined leaf names, the names the checkpoint format
gives them (``params/mask_w2``, ``opt_state/0/mu/gru_fwd_w_ih``,
``step``), so Adam's moments match the param rules through their own
names.  Strict mode raises on a leaf no rule matches: a new TrainState
leaf must be placed deliberately, not silently replicated.
"""

from __future__ import annotations

import re
from typing import Any, Mapping, Sequence

import numpy as np

Spec = tuple  # one axis name (or None) a dimension; () replicates

# Ordered: first match wins.  Patterns run (re.search) against "/"-joined
# leaf names, so ``(^|/)name$`` anchors on the leaf name wherever it sits.
PARTITION_RULES: tuple[tuple[str, Spec], ...] = (
    # -- soft feature mask MLP ------------------------------------------
    (r"(^|/)mask_w1$", ("expert", None)),              # [E, H]
    (r"(^|/)mask_b1$", ("expert", None)),              # [E, H]
    (r"(^|/)mask_w2$", ("expert", None, "model")),     # [E, H, F]  TP out
    (r"(^|/)mask_b2$", ("expert", "model")),           # [E, F]     TP out
    # -- GRU stacks: a deep layer's (_lN) w_ih consumes the previous
    # layer's 2H output, not the TP-sharded feature axis, so it replicates
    # like w_hh.  Order matters: the _lN rule must win before the layer-0
    # w_ih rule below.
    (r"(^|/)gru_(fwd|bwd)_l\d+_w_ih$", ("expert", None, None)),
    (r"(^|/)gru_(fwd|bwd)_w_ih$", ("expert", "model", None)),  # [E, F, 3H]
    (r"(^|/)gru_(fwd|bwd)(_l\d+)?_w_hh$", ("expert", None, None)),
    (r"(^|/)gru_(fwd|bwd)(_l\d+)?_b_(ih|hh)$", ("expert", None)),
    # -- quantile heads --------------------------------------------------
    (r"(^|/)head_w$", ("expert", None, None)),         # [E, 4H, Q]
    (r"(^|/)head_b$", ("expert", None)),               # [E, Q]
    # -- TrainState bookkeeping: replicated everywhere -------------------
    #    step (scalar), the PRNG key, Adam's update counter.
    (r"(^|/)(step|rng|count)$", ()),
)


def leaf_path_name(path: Sequence[Any]) -> str:
    """A key path (strings, ints, or objects with a ``name``, ``key`` or
    ``idx``) → the "/"-joined rule name (``params/mask_w2``,
    ``opt_state/0/mu/head_w``, ``rng``)."""
    parts = []
    for entry in path:
        for attr in ("name", "key", "idx"):
            if hasattr(entry, attr):
                parts.append(str(getattr(entry, attr)))
                break
        else:
            parts.append(str(entry))
    return "/".join(parts)


def _resolve(name: str, shape: tuple, compiled, strict: bool) -> Spec:
    if len(shape) == 0 or int(np.prod(shape, dtype=np.int64)) <= 1:
        return ()
    for pat, spec in compiled:
        if pat.search(name):
            return spec
    if strict:
        raise KeyError(
            f"no partition rule matches leaf {name!r} "
            f"(shape {tuple(shape)}); add a rule to "
            "parallel/sharding.PARTITION_RULES — strict mode refuses "
            "to replicate unknown state silently")
    return ()


def match_partition_rules(leaves: Mapping[str, Any],
                          rules: Sequence[tuple[str, Spec]] = PARTITION_RULES,
                          strict: bool = True) -> dict[str, Spec]:
    """A spec for each leaf of a flat ``{name: array}`` mapping, resolved
    from ``rules``.  Scalar (and single-element) leaves replicate without
    consulting the table; otherwise the FIRST rule whose regex
    ``search``-matches the leaf's name wins.  ``strict`` raises
    ``KeyError`` on an unmatched leaf instead of replicating it."""
    compiled = [(re.compile(pat), spec) for pat, spec in rules]
    return {name: _resolve(name, tuple(np.shape(leaf)), compiled, strict)
            for name, leaf in leaves.items()}


def param_specs(params: Mapping[str, Any]) -> dict[str, Spec]:
    """The spec of each QuantileGRU param by its name (the params slice of
    the table; raises KeyError on an unmatched name)."""
    return match_partition_rules(params, strict=True)


def state_specs(leaves: Mapping[str, Any]) -> dict[str, Spec]:
    """The spec of each leaf of a full TrainState, by the checkpoint's
    "/"-joined names (``params/*``, ``opt_state/0/{mu,nu}/*``,
    ``opt_state/0/count``, ``step``, ``rng``), strictly rule-resolved."""
    return match_partition_rules(leaves, strict=True)


_COMPILED = [(re.compile(pat), spec) for pat, spec in PARTITION_RULES]


def spec_of(name: str, shape: Sequence[int]) -> Spec:
    """The spec of one leaf by its name and global shape (strict)."""
    return _resolve(name, tuple(int(d) for d in shape), _COMPILED, True)


def rank_box(mesh, spec: Spec, shape: Sequence[int],
             name: str = "leaf") -> tuple[tuple[int, int], ...]:
    """This rank's box of a leaf of global ``shape`` placed by ``spec``:
    one ``(lo, hi)`` a dimension, the dimension cut into equal blocks over
    its axis and the rank's block taken by its coordinate there.  A
    dimension the axis does not divide raises, naming the leaf and the
    axis (JAX's ``device_put`` refuses such a placement too)."""
    shape = tuple(int(d) for d in shape)
    box = []
    for dim, size in enumerate(shape):
        axis = spec[dim] if dim < len(spec) else None
        if axis is None:
            box.append((0, size))
            continue
        n = int(mesh.shape[axis])
        if size % n:
            raise ValueError(
                f"leaf {name!r} on mesh axis {axis!r} (spec {spec}) "
                f"implies that the global size of its dimension {dim} "
                f"should be divisible by {n}, but it is equal to {size} "
                f"(full shape: {shape})")
        per = size // n
        c = mesh.coords[axis]
        box.append((c * per, (c + 1) * per))
    return tuple(box)


def expert_feature_box(mesh, mask_w2_shape: Sequence[int]
                       ) -> tuple[tuple[int, int], tuple[int, int]]:
    """This rank's experts and columns of F, as the table places them:
    the expert axis every leaf leads with, and the F axis of the mask's
    output, ``mask_w2`` of global shape ``(E, H, F)``."""
    spec = spec_of("mask_w2", mask_w2_shape)
    e, _, f = (int(d) for d in mask_w2_shape)
    return rank_box(mesh, (spec[0], spec[2]), (e, f), "experts x features")


def box_slices(box) -> tuple[slice, ...]:
    return tuple(slice(lo, hi) for lo, hi in box)


def shard_params(mesh, params: Mapping[str, Any]) -> dict[str, Any]:
    """This rank's box of each full host param (numpy arrays or tensors;
    a tensor's box is a view), placed by the table.  Every rank passes the
    same full params; ``mesh`` None keeps them whole."""
    if mesh is None:
        return dict(params)
    specs = param_specs(params)
    return {name: value[box_slices(rank_box(mesh, specs[name],
                                            np.shape(value), name))]
            for name, value in params.items()}


def box_reader(mesh):
    """The ``box_of(name, shape)`` a rank's checkpoint read takes
    (``train.checkpoint.load_leaves``): each leaf's box by the table on
    ``mesh``; None (whole leaves) on a mesh with no expert or model
    axis."""
    if mesh is None or (mesh.config.expert == 1 and mesh.config.model == 1):
        return None

    def box_of(name: str, shape: tuple) -> tuple:
        return rank_box(mesh, spec_of(name, shape), shape, name)

    return box_of


def gather_leaf(mesh, value, spec: Spec):
    """The whole of one leaf on every rank from each rank's box placed by
    ``spec``: an all-gather along every sharded dimension over its axis's
    group.  Every rank must call it."""
    from deeprest_tpu_torch.parallel.collectives import gather_along

    for dim, axis in enumerate(spec):
        if axis is not None:
            value = gather_along(value, dim, getattr(mesh, f"{axis}_group"))
    return value


def gather_params(mesh, params: Mapping[str, Any],
                  shapes: Mapping[str, tuple]) -> dict[str, Any]:
    """The whole of each param on every rank, from each rank's box
    (:func:`gather_leaf`).  ``shapes`` gives the global shapes; every rank
    must call it."""
    return {name: gather_leaf(mesh, value, spec_of(name, shapes[name]))
            for name, value in params.items()}


def contraction_axis(name: str, shape: Sequence[int]) -> str | None:
    """The mesh axis that shards a matmul weight's contraction dimension
    (its second to last) by the table, or None: the layer-0 ``w_ih`` on
    ``model``."""
    spec = spec_of(name, shape)
    dim = len(shape) - 2
    return spec[dim] if 0 <= dim < len(spec) else None


def replica_writer(mesh, spec: Spec) -> bool:
    """Whether this rank writes its box of a leaf placed by ``spec``: the
    rank is coordinate 0 of every axis the leaf is replicated over, so
    each distinct box is written once (JAX's ``replica_id == 0``)."""
    coords = mesh.coords
    return all(coords[axis] == 0
               for axis in mesh.axis_names if axis not in spec)


def all_boxes(mesh_config, spec: Spec, shape: Sequence[int]
              ) -> list[tuple[tuple[int, int], ...]]:
    """Every distinct box of a leaf over a mesh of ``mesh_config``'s shape
    (the manifest's shard list), in coordinate order."""
    shape = tuple(int(d) for d in shape)
    extents = {"data": mesh_config.data, "expert": mesh_config.expert,
               "model": mesh_config.model}
    per_dim = []
    for dim, size in enumerate(shape):
        axis = spec[dim] if dim < len(spec) else None
        n = 1 if axis is None else extents[axis]
        per = size // n
        per_dim.append([(c * per, (c + 1) * per) for c in range(n)])
    boxes = [()]
    for choices in per_dim:
        boxes = [b + (c,) for b in boxes for c in choices]
    return boxes


__all__ = [
    "PARTITION_RULES",
    "all_boxes",
    "box_reader",
    "box_slices",
    "contraction_axis",
    "gather_leaf",
    "gather_params",
    "leaf_path_name",
    "match_partition_rules",
    "param_specs",
    "rank_box",
    "replica_writer",
    "shard_params",
    "spec_of",
    "state_specs",
]
