"""A one-process device mesh and its collectives.

The port's counterpart of `jax.sharding.Mesh` with one axis, and of the
collectives that `shard_map` gives its bodies.  One process drives every
shard, as the JAX package's single-controller engine does
(dusk_plonk_tpu/proving/sharded_engine.py): the device list may repeat,
so D shards can live on one card (the collectives are then device-local
copies) or spread over several cards (peer copies).

A sharded value is a list of D tensors.  Shard j lives on
`mesh.devices[j]` and holds the j-th contiguous block of the last
(element) axis: the JAX layout `P(..., axis)`.  Every copy between
devices is `.to(device, non_blocking=True)`, on the current streams.

The collectives of the JAX design (`all_to_all`, `all_gather`,
`next_halo`) count nothing: their callers count `collective_bytes` as the
JAX package does, the quantity of parallel/model.py.  The moves that
GSPMD makes implicitly in the JAX package, and the gathers the sharded
engine makes in its place, count the bytes that change shard in the
tracer (utils/tracing.py): `gather_bytes` (`shard`, `gather`),
`relayout_bytes` (`relayout`, `flip`) and `halo_bytes` (`next_halo`,
`prev_halo`).
"""

from __future__ import annotations

import torch

from ..utils.config import get_config
from ..utils.tracing import tracer


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


class Mesh:
    """D devices along one named axis; `devices` may repeat."""

    def __init__(self, devices, axis: str | None = None):
        devs = []
        for d in devices:
            d = torch.device(d)
            if d.type == "cuda" and d.index is None:
                d = torch.device("cuda", torch.cuda.current_device())
            devs.append(d)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        self.devices = tuple(devs)
        self.axis = axis or get_config().mesh_axis
        self.size = len(devs)
        self.lead = devs[0]

    @property
    def shape(self) -> dict:
        """{axis: D}, as `jax.sharding.Mesh.shape`."""
        return {self.axis: self.size}

    def _key(self):
        return self.devices, self.axis

    def __eq__(self, other):
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    def __repr__(self):
        return f"Mesh({[str(d) for d in self.devices]}, {self.axis!r})"


def default_mesh(axis: str | None = None) -> Mesh:
    """One shard on each visible CUDA device; raises when there is none
    (a CPU mesh is made only by passing CPU devices to Mesh)."""
    if not torch.cuda.is_available() or torch.cuda.device_count() == 0:
        raise RuntimeError("default_mesh: no CUDA device is visible; pass "
                           "the devices to Mesh(...) explicitly")
    return Mesh([torch.device("cuda", i)
                 for i in range(torch.cuda.device_count())], axis)


def axis_index(mesh: Mesh):
    """The shard indices 0..D-1 (JAX's `axis_index` inside a body)."""
    return range(mesh.size)


def broadcast(mesh: Mesh, x):
    """A small tensor (a scalar, a challenge) copied to every shard's
    device; uncounted, as the JAX package replicates them from the host."""
    return [x.to(d, non_blocking=True) for d in mesh.devices]


def shard(mesh: Mesh, x):
    """One tensor -> D contiguous blocks of its last axis, block j on
    devices[j]."""
    D = mesh.size
    w, r = divmod(x.shape[-1], D)
    if r:
        raise ValueError(f"shard: {x.shape[-1]} elements over {D} shards")
    out = [x[..., j * w:(j + 1) * w].to(d, non_blocking=True).contiguous()
           for j, d in enumerate(mesh.devices)]
    tracer.count("gather_bytes", _nbytes(x) * (D - 1) // D)
    return out


def gather(mesh: Mesh, xs, device=None):
    """A sharded value -> one tensor on `device` (default the lead)."""
    device = mesh.lead if device is None else device
    out = torch.cat([x.to(device, non_blocking=True) for x in xs], dim=-1)
    tracer.count("gather_bytes", _nbytes(out) * (mesh.size - 1)
                 // mesh.size)
    return out


def all_to_all(mesh: Mesh, xs, split_axis: int, concat_axis: int):
    """`jax.lax.all_to_all(..., tiled=True)`: shard i splits its tensor
    into D chunks along split_axis and sends chunk j to shard j, which
    concatenates what it receives, ordered by source, along
    concat_axis."""
    D = mesh.size
    chunks = [x.chunk(D, dim=split_axis) for x in xs]
    return [torch.cat([chunks[i][j].to(d, non_blocking=True)
                       for i in range(D)], dim=concat_axis)
            for j, d in enumerate(mesh.devices)]


def all_gather(mesh: Mesh, xs):
    """`jax.lax.all_gather`: every shard j gets the (D, ...) stack of all
    shards' tensors on its device."""
    return [torch.stack([x.to(d, non_blocking=True) for x in xs])
            for d in mesh.devices]


def next_halo(mesh: Mesh, xs, m: int):
    """Shard j gets the first m elements of shard j + 1, wrapping: with
    them, `cat(x_j[..., m:], halo_j)` is shard j of `roll(x, -m)`, the
    boundary permute XLA derives from `jnp.roll` on a sharded axis."""
    D = mesh.size
    out = [xs[(j + 1) % D][..., :m].to(d, non_blocking=True)
           for j, d in enumerate(mesh.devices)]
    tracer.count("halo_bytes", sum(_nbytes(h) for h in out))
    return out


def prev_halo(mesh: Mesh, xs, m: int):
    """Shard j gets the last m elements of shard j - 1, wrapping (the
    halo of `roll(x, m)`)."""
    D = mesh.size
    out = [xs[(j - 1) % D][..., -m:].to(d, non_blocking=True)
           for j, d in enumerate(mesh.devices)]
    tracer.count("halo_bytes", sum(_nbytes(h) for h in out))
    return out


def flip(mesh: Mesh, xs):
    """The sharded value reversed along its element axis: shard j is shard
    D - 1 - j flipped, moved to devices[j]."""
    D = mesh.size
    out = [xs[D - 1 - j].flip(-1).to(d, non_blocking=True)
           for j, d in enumerate(mesh.devices)]
    tracer.count("relayout_bytes", sum(_nbytes(x) for j, x in enumerate(out)
                                       if j != D - 1 - j))
    return out


def relayout(mesh: Mesh, xs, width: int):
    """A sharded value of D * w elements -> the same elements, zero-padded
    or cut to `width` (a multiple of D), sharded anew: shard j takes the
    pieces of the old shards that overlap its block."""
    D = mesh.size
    w_old = xs[0].shape[-1]
    w, r = divmod(width, D)
    if r:
        raise ValueError(f"relayout: {width} elements over {D} shards")
    out, moved = [], 0
    for j, d in enumerate(mesh.devices):
        lo, hi = j * w, (j + 1) * w
        pieces = []
        for i in range(lo // w_old, min(D, -(-hi // w_old))):
            a, b = max(lo, i * w_old), min(hi, (i + 1) * w_old)
            p = xs[i][..., a - i * w_old:b - i * w_old]
            if i != j:
                moved += _nbytes(p)
            pieces.append(p.to(d, non_blocking=True))
        got = sum(p.shape[-1] for p in pieces)
        if got < w:
            pieces.append(torch.zeros(xs[0].shape[:-1] + (w - got,),
                                      dtype=xs[0].dtype, device=d))
        out.append(torch.cat(pieces, dim=-1))
    tracer.count("relayout_bytes", moved)
    return out
