"""Sharded particle clouds with all_to_all migration.

Reference semantics: markers live on the MPI rank that owns their current
element; when advection walks a marker across a partition boundary the
marker is handed to the new owner (Marker.cpp GetElement cross-proc
migration, Line::AdvectionParallel per-proc hand-off loops, SURVEY.md
§3.5).

Design (the JAX package's, one process per rank): each rank holds a
fixed-capacity struct-of-arrays block of ``capacity`` slots (dead slots
carry ``elem = -1``); mesh geometry and the velocity field are replicated,
so a particle's state is (x, elem).  One advection step on a rank:

  local RK substep + neighbour-walk relocation (``markers.make_advect_fn``)
  -> destination rank = elem_owner[elem]
  -> pack out-migrating particles into (S, cap_migrate) slot buffers
  -> ``dist.all_to_all_single`` of positions and elements
  -> merge survivors + arrivals by a stable alive-first sort (repack).

Every shape is fixed: the per-peer migration capacity is a plan
parameter; overflow drops particles deterministically, and the drops are
counted over the ranks (one ``all_reduce``, returned by every step), never
silent.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch

from ..mesh.mesh import Mesh
from ..parallel.ranks import RankGroup
from .markers import MarkerCloud, make_advect_fn


@dataclasses.dataclass
class ShardedCloudPlan:
    n_shards: int
    capacity: int            # particle slots per shard
    cap_migrate: int         # per-(src,dst) migration slots per step
    elem_owner: np.ndarray   # (n_elems,) element -> shard id


def make_plan(mesh: Mesh, n_shards: int, n_particles: int,
              cap_migrate: int = 0, slack: float = 2.0) -> ShardedCloudPlan:
    """Shard elements contiguously (matching the partitioner's
    shard-contiguous element reordering) and size the per-shard buffers."""
    n_elems = mesh.n_elems
    per = -(-n_elems // n_shards)
    owner = np.minimum(np.arange(n_elems) // per, n_shards - 1)
    capacity = max(4, int(np.ceil(slack * n_particles / n_shards)))
    cap_migrate = cap_migrate or max(2, capacity // 4)
    return ShardedCloudPlan(n_shards, capacity, cap_migrate,
                            owner.astype(np.int32))


def distribute(cloud: MarkerCloud, plan: ShardedCloudPlan
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side: place each particle into a slot on its owner shard, in
    cloud order.  Returns global (S*C, dim) x and (S*C,) elem arrays
    (rank s's block is rows [s*C, (s+1)*C)); dead slots have elem = -1."""
    S, C = plan.n_shards, plan.capacity
    dim = cloud.x.shape[1]
    live = np.flatnonzero(cloud.elem >= 0)
    shard = plan.elem_owner[cloud.elem[live]].astype(np.int64)
    order = np.argsort(shard, kind="stable")
    counts = np.bincount(shard, minlength=S)
    if counts.max(initial=0) > C:
        s = int(np.argmax(counts))
        raise ValueError(f"shard {s} over capacity {C}")
    start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot = np.empty(len(live), np.int64)
    slot[order] = np.arange(len(live)) - start[shard[order]]
    x = np.zeros((S, C, dim), cloud.x.dtype)
    elem = np.full((S, C), -1, np.int64)
    x[shard, slot] = cloud.x[live]
    elem[shard, slot] = cloud.elem[live]
    return x.reshape(S * C, dim), elem.reshape(S * C)


def collect(x, elem) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side: the live particles of the sharded layout (all ranks'
    blocks concatenated in rank order)."""
    x = np.asarray(x)
    elem = np.asarray(elem)
    alive = elem >= 0
    return x[alive], elem[alive]


def make_sharded_advect_fn(mesh: Mesh, plan: ShardedCloudPlan,
                           group: RankGroup, vel_families: Sequence[str],
                           order: int = 2, max_hops: int = 4,
                           dtype=None):
    """Build ``step(x_blk (C, dim), elem_blk (C,), vel_dofs, dt) ->
    (x_blk, elem_blk, n_dropped)`` on this rank's block (the rank's
    device); ``vel_dofs``: replicated (n_dofs,) tensors per component;
    ``n_dropped``: particles lost to migration-capacity overflow over all
    ranks in this step.  ``step.migrated``: the particles that changed
    rank in the last step (over all ranks)."""
    S, C, M = plan.n_shards, plan.capacity, plan.cap_migrate
    if group.world_size != S:
        raise ValueError(f"plan of {S} shards on {group.world_size} ranks")
    dev = group.device
    local_step = make_advect_fn(mesh, vel_families, order=order,
                                max_hops=max_hops, dtype=dtype, device=dev)
    elem_owner = torch.as_tensor(plan.elem_owner, dtype=torch.int64,
                                 device=dev)
    dim = mesh.dim
    me = group.rank
    shards = torch.arange(S, device=dev)

    def exchange(send: torch.Tensor) -> torch.Tensor:
        if not group.distributed:
            return send
        recv = torch.empty_like(send)
        torch.distributed.all_to_all_single(recv, send.contiguous())
        return recv

    def step(x, e, vel_dofs, dt):
        x, e = local_step(x, e, vel_dofs, dt)
        alive = e >= 0
        dest = torch.where(alive, elem_owner[e.clamp(min=0)],
                           torch.full_like(e, me))
        stay = alive & (dest == me)
        leaving = alive & (dest != me)
        # rank of each leaving particle within its destination group
        onehot = leaving[None, :] & (dest[None, :] == shards[:, None])
        rank = torch.cumsum(onehot.to(torch.int64), dim=1) - 1     # (S, C)
        slot = torch.where(onehot, rank, -1).max(dim=0).values      # (C,)
        dropped = (leaving & (slot >= M)).sum()
        ok = leaving & (slot < M)
        send_x = x.new_zeros((S, M, dim))
        send_e = torch.full((S, M), -1, dtype=e.dtype, device=dev)
        send_x[dest[ok], slot[ok]] = x[ok]
        send_e[dest[ok], slot[ok]] = e[ok]
        recv_x = exchange(send_x.reshape(S * M, dim))
        recv_e = exchange(send_e.reshape(S * M))
        # merge: survivors first, then arrivals; stable alive-first repack
        all_x = torch.cat([x, recv_x])
        all_e = torch.cat([torch.where(stay, e, torch.full_like(e, -1)),
                           recv_e])
        order_ = torch.argsort((all_e < 0).to(torch.int8), stable=True)
        packed_e = all_e[order_][:C]
        packed_x = all_x[order_][:C]
        n_over = (all_e >= 0).sum() - (packed_e >= 0).sum()
        counts = group.sum(torch.stack([dropped + n_over, ok.sum()]))
        step.migrated = int(counts[1])
        return packed_x, packed_e, int(counts[0])

    step.migrated = 0
    return step
