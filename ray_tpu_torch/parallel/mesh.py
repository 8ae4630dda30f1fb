"""Device-mesh construction (PyTorch port of `ray_tpu/parallel/mesh.py`).

The mesh is a `torch.distributed` DeviceMesh over the ranks of the
process group, one card per rank, with the JAX package's six named
axes, outer to inner (inner axes get the fastest links):

    dcn_dp - data parallel across slices (hosts joined by the slow
             network: they carry only the per-step gradient all-reduce)
    pp     - pipeline-parallel stage
    dp     - pure data parallel (replicated params)
    fsdp   - data parallel with sharded params/optimizer (ZeRO-3)
    sp     - sequence/context parallel
    tp     - tensor parallel (innermost, highest traffic)

`ep` (expert parallelism) is folded into the others, as in the JAX
package. Ranks fill the mesh in row-major order, so `dcn_dp` is
outermost in contiguous rank blocks: the layout of JAX's hybrid mesh
when no slice topology is reported.

The pipeline step (`make_pp_train_step`) takes a mesh of its own,
`pipeline_mesh`: axes ("pp", "sp", "ep"), where `ep` is a named axis
that doubles as the data axis.
"""

from __future__ import annotations

import math
from collections import defaultdict
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

AXES = ("dcn_dp", "pp", "dp", "fsdp", "sp", "tp")
PIPELINE_AXES = ("pp", "sp", "ep")


def group_by_slice(ranks: Sequence[int],
                   slice_of: Optional[Callable[[int], int]] = None
                   ) -> List[list]:
    """Partition ranks into slices by `slice_of(rank)`; without it every
    rank is in one slice (callers then split explicitly)."""
    groups: Dict[int, list] = defaultdict(list)
    for r in ranks:
        groups[slice_of(r) if slice_of else 0].append(r)
    return [groups[k] for k in sorted(groups)]


def _world_size() -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return max(torch.cuda.device_count(), 1)


@dataclass(frozen=True)
class MeshSpec:
    """Logical parallelism layout; `build()` realizes it on the ranks."""

    dp: int = 1
    fsdp: int = 1
    tp: int = 1
    sp: int = 1
    pp: int = 1
    ep: int = 1  # folded into (sp, tp), as in the JAX package
    dcn_dp: int = 1  # data-parallel replicas across slices

    def num_devices(self) -> int:
        return (
            self.dcn_dp * self.dp * self.fsdp * self.tp * self.sp * self.pp
        )

    @staticmethod
    def auto(
        n_devices: Optional[int] = None,
        *,
        tp: int = 1,
        sp: int = 1,
        pp: int = 1,
        dcn_dp: int = 1,
    ) -> "MeshSpec":
        """Fill the fsdp axis with whatever ranks remain (the world's
        size, or the cards this process sees outside a world)."""
        n = n_devices if n_devices is not None else _world_size()
        denom = tp * sp * pp * dcn_dp
        if n % denom != 0:
            raise ValueError(
                f"{n} devices not divisible by tp*sp*pp*dcn_dp={denom}"
            )
        return MeshSpec(
            fsdp=n // denom, tp=tp, sp=sp, pp=pp, dcn_dp=dcn_dp
        )

    def build(self, device="cuda", *,
              ranks: Optional[Sequence[int]] = None,
              slice_of: Optional[Callable[[int], int]] = None) -> DeviceMesh:
        """The DeviceMesh over `ranks` (default: every rank of the
        process group) on `device`'s type: "cuda" for a world on NCCL,
        "cpu" for one on gloo. `slice_of(rank)` names a rank's slice for
        `dcn_dp > 1`; without it the ranks split into contiguous blocks."""
        ranks = list(ranks if ranks is not None else range(_world_size()))
        need = self.num_devices()
        if len(ranks) < need:
            raise ValueError(
                f"MeshSpec needs {need} devices, have {len(ranks)}"
            )
        if self.dcn_dp > 1:
            grid = self._hybrid_grid(ranks, slice_of)
        else:
            grid = np.array(ranks[:need]).reshape(
                (1, self.pp, self.dp, self.fsdp, self.sp, self.tp))
        return DeviceMesh(torch.device(device).type, torch.as_tensor(grid),
                          mesh_dim_names=AXES)

    def _hybrid_grid(self, ranks: Sequence[int],
                     slice_of: Optional[Callable[[int], int]]) -> np.ndarray:
        """Outer dcn_dp axis = one slice per entry, inner axes laid out
        within each slice (JAX's `_build_hybrid`)."""
        slices = group_by_slice(ranks, slice_of)
        per_slice = self.num_devices() // self.dcn_dp
        if len(slices) == 1:
            # No slice topology: contiguous rank blocks, so the inner
            # axes never straddle a block.
            flat = sorted(slices[0])
            slices = [
                flat[i * per_slice : (i + 1) * per_slice]
                for i in range(self.dcn_dp)
            ]
        if len(slices) < self.dcn_dp:
            raise ValueError(
                f"dcn_dp={self.dcn_dp} but only {len(slices)} slices"
            )
        for group in slices[: self.dcn_dp]:
            if len(group) < per_slice:
                raise ValueError(
                    f"slice contributes {len(group)} devices, "
                    f"need {per_slice} per slice"
                )
        inner = (1, self.pp, self.dp, self.fsdp, self.sp, self.tp)
        return np.stack([
            np.array(group[:per_slice]).reshape(inner)[0]
            for group in slices[: self.dcn_dp]
        ])

    def axis_sizes(self) -> Dict[str, int]:
        return {
            "dcn_dp": self.dcn_dp,
            "pp": self.pp,
            "dp": self.dp,
            "fsdp": self.fsdp,
            "sp": self.sp,
            "tp": self.tp,
        }


def single_host_mesh(device="cuda", **axis_sizes) -> DeviceMesh:
    return MeshSpec(**axis_sizes).build(device)


def pipeline_mesh(pp: int = 1, sp: int = 1, ep: int = 1,
                  device="cuda") -> DeviceMesh:
    """The ("pp", "sp", "ep") mesh of `make_pp_train_step` over the first
    pp * sp * ep ranks of the process group, filled in row-major order as
    JAX's `Mesh(devices.reshape(pp, sp, ep))`. Every rank of the group
    must call it; a rank outside the mesh gets None from
    `get_coordinate()`. A NCCL group bound to its card (as
    `init_torch_distributed` makes it) splits a mesh's groups off on
    their members only, after which later groups differ between ranks:
    there the mesh must span the whole group."""
    need = pp * sp * ep
    world = _world_size()
    if need > world:
        raise ValueError(f"a pp={pp} x sp={sp} x ep={ep} mesh needs {need} "
                         f"ranks, the group has {world}")
    bound = getattr(dist.distributed_c10d._get_default_group(),
                    "bound_device_id", None)
    if need < world and bound is not None:
        raise ValueError(f"a mesh of {need} of {world} ranks on a group "
                         "bound to its card: build it over the whole group")
    grid = torch.arange(need).reshape(pp, sp, ep)
    return DeviceMesh(torch.device(device).type, grid,
                      mesh_dim_names=PIPELINE_AXES)


def data_axes() -> Tuple[str, ...]:
    """Mesh axes a batch dimension is sharded over."""
    return ("dcn_dp", "dp", "fsdp")


def model_axes() -> Tuple[str, ...]:
    return ("tp",)


def axis_size(mesh: DeviceMesh, name: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(name))


def batch_size_per_host(global_batch: int, mesh: DeviceMesh) -> int:
    n_data = math.prod(axis_size(mesh, a) for a in data_axes())
    if global_batch % n_data != 0:
        raise ValueError(
            f"global batch {global_batch} not divisible by data-parallel "
            f"size {n_data}"
        )
    return global_batch // n_data
