"""Logical-axis sharding rules -> DTensor placements (PyTorch port of
`ray_tpu/parallel/sharding.py`).

Parameters and activations carry *logical* axis names and a rule table
maps them onto mesh axes, as in the JAX package. Where JAX turns a rule
into a `NamedSharding` and leaves the collectives to GSPMD, the port
turns it into DTensor placements (`placements_for`), one per mesh axis:
`Shard(d)` on the mesh axes that tensor dim d is spread over,
`Replicate()` on the others.

Default rule table (transformer nomenclature):

    batch   -> (dcn_dp, dp, fsdp)  activations data-parallel
    seq     -> sp                  sequence/context parallelism
    embed   -> fsdp (params)       ZeRO-3-style parameter sharding
    heads   -> tp                  attention-head tensor parallelism
    mlp     -> tp                  feed-forward tensor parallelism
    vocab   -> tp                  embedding/logit sharding
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

from torch.distributed.tensor import Replicate, Shard, distribute_tensor

Rules = Dict[str, Union[str, Tuple[str, ...], None]]

#: Parameter rules: fsdp shards the embed dim of weights (ZeRO-3).
#: Parameters are replicated across dcn_dp: the only cross-slice
#: traffic is then the per-step gradient all-reduce.
PARAM_RULES: Rules = {
    "batch": ("dcn_dp", "dp", "fsdp"),
    "seq": None,
    "embed": "fsdp",
    "heads": "tp",
    "kv_heads": "tp",
    "mlp": "tp",
    "vocab": "tp",
    "expert": None,
    "layers": None,
    "head_dim": None,
}

#: Activation rules: batch over the data axes, seq over sp, heads over tp.
ACT_RULES: Rules = {
    "batch": ("dcn_dp", "dp", "fsdp"),
    "seq": "sp",
    "embed": None,
    "heads": "tp",
    "kv_heads": "tp",
    "mlp": "tp",
    "vocab": "tp",
    "expert": None,
    "head_dim": None,
}


def spec_for(logical_axes: Sequence[Optional[str]], rules: Rules) -> tuple:
    """The mesh axes of each tensor dim (the counterpart of JAX's
    PartitionSpec): a mesh axis name, a tuple of them, or None."""
    return tuple(None if name is None else rules.get(name)
                 for name in logical_axes)


def placements_for(mesh, logical_axes: Sequence[Optional[str]],
                   rules: Rules) -> List[Any]:
    """DTensor placements on `mesh` (a DeviceMesh with named axes) of a
    tensor whose dims carry `logical_axes`. A tensor dim spread over
    several mesh axes is split over them major to minor, as JAX splits
    it; they must then come in the mesh's own order."""
    names = mesh.mesh_dim_names
    placements: List[Any] = [Replicate() for _ in names]
    for dim, axes in enumerate(spec_for(logical_axes, rules)):
        axes = (axes,) if isinstance(axes, str) else tuple(axes or ())
        where = [names.index(a) for a in axes if a in names]
        if where != sorted(where):
            raise ValueError(
                f"dim {dim} is spread over {axes}, out of the mesh's order "
                f"{names}")
        for i in where:
            if placements[i] != Replicate():
                raise ValueError(
                    f"mesh axis {names[i]!r} shards more than one dim of "
                    f"{tuple(logical_axes)}")
            placements[i] = Shard(dim)
    return placements


def tensor_dim_on(logical_axes: Sequence[Optional[str]], rules: Rules,
                  mesh_axis: str) -> Optional[int]:
    """The tensor dim that `rules` put on `mesh_axis`, or None."""
    for dim, axes in enumerate(spec_for(logical_axes, rules)):
        axes = (axes,) if isinstance(axes, str) else tuple(axes or ())
        if mesh_axis in axes:
            return dim
    return None


@dataclass(frozen=True)
class Annotated:
    """A leaf annotation: tensor dims <-> logical axis names."""

    logical_axes: Tuple[Optional[str], ...]


def annotate(*logical_axes: Optional[str]) -> Annotated:
    return Annotated(tuple(logical_axes))


def tree_map(fn, tree, *rest):
    """`fn` over the leaves of nested dicts, lists and tuples (and the
    leaves at the same places in `rest`)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_shardings(mesh, annotations: Any, rules: Rules) -> Any:
    """Map a tree of `Annotated` (or None: replicated) to placements."""

    def leaf(a):
        if isinstance(a, Annotated):
            return placements_for(mesh, a.logical_axes, rules)
        return [Replicate() for _ in mesh.mesh_dim_names]

    return tree_map(leaf, annotations)


def distribute(x, mesh, placements):
    """`x` as a DTensor of `placements`: each rank keeps its own shard of
    the whole `x` it holds and no data moves between ranks, so every
    rank must hold the same `x`."""
    return distribute_tensor(x, mesh, placements, src_data_rank=None)


def shard_tree(mesh, tree: Any, annotations: Any, rules: Rules) -> Any:
    """Distribute a tree of tensors according to its annotations; every
    rank holds the same whole tree (`distribute`)."""
    return tree_map(lambda x, p: distribute(x, mesh, p), tree,
                    tree_shardings(mesh, annotations, rules))
