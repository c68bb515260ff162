"""Device meshes (counterpart of tpu_knn/parallel/mesh.py).

tpu_knn shards a corpus over a ``jax.sharding.Mesh``: queries are
replicated, each device scans its rows, and the per-shard top-k merge
rides the interconnect (the reference's thread-sharded scan + merge,
seqsearch.cc:73-98, 163-176). The port is single-controller: a
:class:`Mesh` is a numpy object array of ``torch.device``s, one entry per
logical shard, and shards on distinct cards exchange only their [Q, k]
results by ``.to(device)``. No process group is involved; tpu_knn has no
multi-process path either.

Logical shards: a mesh may hold more shards than there are devices of its
type. Shard ``i`` is placed on device ``i % count`` (every shard on
``cpu`` for a CPU mesh), the counterpart of XLA's forced host devices on
which tpu_knn's tests run its 8-shard meshes.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.logging import log

SHARD_AXIS = "shard"
#: two-tier mesh axis names: the slow inter-host tier, the fast intra-host tier
DCN_AXIS = "dcn"
ICI_AXIS = "ici"


class Mesh:
    """Logical shards on torch devices: ``devices`` is a numpy object array
    (1-D, or 2-D [dcn, ici] for two tiers) with one axis name per
    dimension. Shard ``si`` of a row-split corpus lives on
    ``devices.flat[si]`` (row-major, as a ``PartitionSpec`` over all axes
    splits rows)."""

    def __init__(self, devices: np.ndarray, axis_names: tuple[str, ...]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-D devices with axis names {axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def device(self, si: int) -> torch.device:
        """The device of shard ``si`` (row-major over the mesh)."""
        return self.devices.flat[si]

    def physical_devices(self) -> list[torch.device]:
        """The distinct devices the shards use, in first-use order."""
        return list(dict.fromkeys(self.devices.flat))

    def __repr__(self):
        return f"Mesh({self.shape}, devices={[str(d) for d in self.physical_devices()]})"


def _placed(n: int, device) -> np.ndarray:
    """``n`` logical shards on the devices of ``device``'s type, shard i
    on device i % count. A CUDA type without a card raises as
    ``Index(device="cuda")`` does."""
    from ..api import _resolve_device

    dev = _resolve_device(device)
    if dev.type == "cuda":
        count = torch.cuda.device_count()
        devs = [torch.device("cuda", i % count) for i in range(n)]
    else:
        count = 1
        devs = [torch.device("cpu")] * n
    out = np.empty(n, dtype=object)
    out[:] = devs
    log("INFO", f"mesh: {n} shards on {min(n, count)} physical {dev.type} device(s)")
    return out


def make_mesh(num_devices: int | None = None, axis: str = SHARD_AXIS, device="cuda") -> Mesh:
    """A 1-D mesh of ``num_devices`` shards (default: one per device of
    ``device``'s type)."""
    if num_devices is None:
        num_devices = torch.cuda.device_count() if torch.device(device).type == "cuda" else 1
    if num_devices < 1:
        raise ValueError(f"a mesh needs at least one shard, got {num_devices}")
    return Mesh(_placed(num_devices, device), (axis,))


def make_mesh2(dcn: int, ici: int, device="cuda") -> Mesh:
    """Two-tier mesh [dcn, ici]: the leading axis is the slow tier, the
    trailing one the fast tier; each row of ``devices`` is one ICI group.
    The hierarchical merge (parallel/sharded.py sharded_exact_knn_hier)
    merges within each row first, so only [Q, k] per row crosses DCN."""
    if dcn < 1 or ici < 1:
        raise ValueError(f"a mesh needs at least one shard per axis, got [{dcn}, {ici}]")
    return Mesh(_placed(dcn * ici, device).reshape(dcn, ici), (DCN_AXIS, ICI_AXIS))


def shard_rows(mesh: Mesh, x: torch.Tensor) -> list[torch.Tensor]:
    """``x`` split into mesh.size equal row blocks, block i on shard i's
    device (the row count must divide evenly, as under a PartitionSpec)."""
    s = mesh.size
    if x.shape[0] % s:
        raise ValueError(f"{x.shape[0]} rows do not split over {s} shards")
    n = x.shape[0] // s
    return [x[i * n:(i + 1) * n].to(mesh.device(i)) for i in range(s)]


def replicate(mesh: Mesh, x: torch.Tensor) -> list[torch.Tensor]:
    """One copy of ``x`` per shard, on its device (shared where shards
    share a device)."""
    return [x.to(mesh.device(i)) for i in range(mesh.size)]
