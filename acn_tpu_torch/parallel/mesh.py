"""The (expert × data) mesh on ``torch.distributed``.

Port of ``acn_tpu/parallel/mesh.py``. ``acn_tpu`` lays the K experts of a
city over a 2D device mesh (expert, data) and lets XLA's partitioner insert
the collectives; here each rank is one process with one device, and the
collectives are written out where the step, the loop and the checkpoints
need them:

* ``maybe_init_distributed(P)`` starts the process group from the flags or
  the environment (``COORDINATOR_ADDRESS``, ``PROCESS_ID``,
  ``NUM_PROCESSES``, or their ``JAX_`` names), with the backend rule: NCCL
  when every rank has a card of its own, gloo when ranks share a card or run
  on the CPU (the ranks tell each other their host and its cards through
  the rendezvous store first). An NCCL failure raises; nothing switches to
  gloo after it.
* ``make_mesh(K, mesh_experts, mesh_data)`` → a ``Mesh``: rank r sits at
  (r // D, r % D), holds experts ``[k0, k1)`` and, of each expert's T tasks,
  ``task_range(T)``. ``make_render_mesh()`` puts every rank on one ``px``
  axis (the frame's row blocks). Both return None for one rank; a one-rank
  ``Mesh`` is built directly (``init_one_rank``, then ``Mesh.build``), as
  ``bench_render --mesh 1`` does, to measure the machinery.
* ``shard_by_expert_axis(tree, mesh, K)`` keeps this rank's slice of what is
  per expert, by position in the tree: the ``experts`` subtree of the
  parameters and of the optimizer moments, the occupancy states, the device
  pools and the batch (all T tasks of its experts: the step runs
  ``task_range(T)`` of them). A leaf elsewhere stays whole whatever its shape
  (a background layer of width K is not an expert axis).

Collectives on device tensors use ``all_reduce`` only (with ``broadcast``
and ``barrier``, all that gloo promises for CUDA tensors); a gather is an
``all_reduce`` of a zero-filled tensor. Host tensors (frame blocks, the stop
flag, metric counts) go over a gloo group, the world's own under gloo.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import math
import os
import socket
import urllib.parse
from datetime import timedelta
from typing import Any, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from acn_tpu_torch.models.nn import tree_leaves, tree_map

DEFAULT_TIMEOUT_S = 600.0
_HOST_GROUP = None  # the gloo group of the world for host tensors
_BACKEND: Optional[str] = None
_LOCAL_RANK: Optional[int] = None  # this rank's index among its host's ranks


def _env(*names) -> Optional[str]:
    for n in names:
        if os.environ.get(n):
            return os.environ[n]
    return None


def distributed_settings(P=None) -> Tuple[Optional[str], Optional[str], Optional[str]]:
    """(coordinator address, process id, process count) from ``P``'s flags,
    else the environment, as ``acn_tpu`` reads them."""
    coord = _env("COORDINATOR_ADDRESS", "JAX_COORDINATOR_ADDRESS")
    pid = _env("PROCESS_ID", "JAX_PROCESS_ID")
    nproc = _env("NUM_PROCESSES", "JAX_NUM_PROCESSES")
    if P is not None:
        coord = getattr(P, "coordinator_address", None) or coord
        if getattr(P, "process_id", None) is not None:
            pid = getattr(P, "process_id")
        nproc = getattr(P, "num_processes", None) or nproc
    return coord, pid, nproc


def choose_backend(hosts: Sequence[Tuple[str, int]], device_type: str) -> Tuple[str, str]:
    """(backend, why) for ranks on ``hosts`` (each rank's host name and the
    cards there, in rank order): NCCL when every host has a card for each of
    its ranks, gloo when ranks share a card or run on the CPU."""
    if device_type != "cuda":
        return "gloo", "ranks on the CPU"
    ranks, cards = collections.Counter(h for h, _ in hosts), dict(hosts)
    for host, n in ranks.items():
        if n > cards[host]:
            return "gloo", f"{n} ranks share {cards[host]} card(s) on {host}"
    return "nccl", f"{len(hosts)} ranks on {len(ranks)} host(s): a card each"


def local_rank() -> int:
    """This process's rank among the ranks of its host (0 outside a process
    group)."""
    return _LOCAL_RANK or 0


def rank_device(device=None) -> torch.device:
    """This rank's device: ``cuda:{local rank}`` (modulo the cards, where
    ranks share them) for the card, the CPU when asked for. ``None`` is the
    card."""
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda" or device.index is not None:
        return device
    n = max(torch.cuda.device_count(), 1)
    return torch.device("cuda", local_rank() % n)


def _store(init_method: str, world_size: int, rank: int, timeout: timedelta):
    """The rendezvous store at ``init_method``: ``tcp://host:port`` (rank 0
    serves it) or ``file:///path`` (a file every rank can reach)."""
    url = urllib.parse.urlparse(init_method)
    if url.scheme == "tcp" and url.hostname and url.port:
        return dist.TCPStore(url.hostname, url.port, world_size, rank == 0, timeout=timeout)
    if url.scheme == "file" and url.path:
        store = dist.FileStore(url.path, world_size)
        store.set_timeout(timeout)
        return store
    raise ValueError(f"coordinator {init_method!r}: host:port, tcp://host:port or "
                     "file:///path")


def _hosts(store, world_size: int, rank: int, device_type: str) -> List[Tuple[str, int]]:
    """Every rank's (host name, cards on that host), exchanged through the
    rendezvous store before the process group starts."""
    cards = torch.cuda.device_count() if device_type == "cuda" else 0
    store.set(f"acn_mesh/host/{rank}", json.dumps([socket.gethostname(), cards]))
    return [tuple(json.loads(store.get(f"acn_mesh/host/{r}"))) for r in range(world_size)]


def init_distributed(init_method: Optional[str], world_size: int, rank: int,
                     device_type: str = "cuda",
                     timeout_s: float = DEFAULT_TIMEOUT_S, store=None) -> str:
    """Start the process group (rendezvous at ``init_method``, or through
    ``store``) and the host group. The ranks first tell each other their
    host and its cards, which give the backend rule its input and each rank
    its local rank; one line names the backend. Returns the backend."""
    global _HOST_GROUP, _BACKEND, _LOCAL_RANK
    timeout = timedelta(seconds=float(timeout_s))
    if store is None:
        store = _store(init_method, int(world_size), int(rank), timeout)
    hosts = _hosts(store, int(world_size), int(rank), device_type)
    backend, why = choose_backend(hosts, device_type)
    local = [h for h, _ in hosts[:rank]].count(hosts[rank][0])
    if device_type == "cuda":  # this rank's card: cuda:{local rank} (shared: modulo)
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend, store=store, world_size=int(world_size), rank=int(rank),
                            timeout=timeout)
    _BACKEND, _LOCAL_RANK = backend, local
    _HOST_GROUP = dist.new_group(backend="gloo") if backend != "gloo" else dist.group.WORLD
    print(f"[mesh] rank {rank}/{world_size}: backend {backend} ({why}), device "
          f"{rank_device(device_type) if device_type == 'cuda' else 'cpu'}", flush=True)
    return backend


def init_one_rank(device_type: str = "cuda") -> str:
    """A process group of this process alone (an in-memory store), for a
    one-rank ``Mesh``: its collectives run, as copies."""
    return init_distributed(None, 1, 0, device_type, store=dist.HashStore())


def maybe_init_distributed(P=None, device=None,
                           timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Start the multi-process runtime when the flags or the environment ask
    for it (``acn_tpu``'s settings and errors); returns True when this
    process is one of several. ``device`` is the run's device (``None``: the
    card), which picks the backend. The coordinator is ``host:port`` (TCP)
    or a URL (``file:///path`` rendezvous through a shared file)."""
    coord, pid, nproc = distributed_settings(P)
    if coord is None and nproc is None:
        return False  # single-process
    if pid is None or nproc is None or (coord is None and int(nproc) > 1):
        raise ValueError(
            "Multi-host init needs all three of coordinator_address, "
            f"process_id, num_processes — got coordinator_address={coord!r}, "
            f"process_id={pid!r}, num_processes={nproc!r}")
    if int(nproc) <= 1:
        return False
    if dist.is_initialized():
        return dist.get_world_size() > 1
    url = coord if "://" in coord else f"tcp://{coord}"
    init_distributed(url, int(nproc), int(pid),
                     torch.device("cuda" if device is None else device).type, timeout_s)
    return True


def host_barrier() -> None:
    """Wait for every rank, over the host group (no wait for the card)."""
    dist.barrier(group=_HOST_GROUP)


def shutdown() -> None:
    """Leave the process group (every rank)."""
    global _HOST_GROUP, _BACKEND, _LOCAL_RANK
    if dist.is_initialized():
        dist.destroy_process_group()
    _HOST_GROUP = _BACKEND = _LOCAL_RANK = None


def host_group():
    """The world's gloo group for host tensors (None before the process
    group is up)."""
    return _HOST_GROUP


def backend() -> Optional[str]:
    return _BACKEND


def world_rank() -> Tuple[int, int]:
    if not dist.is_initialized():
        return 1, 0
    return dist.get_world_size(), dist.get_rank()


def mesh_shape(num_experts: int, n: int, mesh_experts: Optional[int] = None,
               mesh_data: int = 1) -> Tuple[int, int]:
    """(E, D) over n ranks, as ``acn_tpu``'s ``make_mesh`` shapes it: E
    defaults to gcd(K, n / mesh_data), and D is then n // E."""
    if mesh_experts is None:
        mesh_experts = math.gcd(num_experts, max(n // max(mesh_data or 1, 1), 1))
    return int(mesh_experts), int(n // mesh_experts)


@dataclasses.dataclass
class Mesh:
    """This rank's place on a mesh of ``shape`` = (E, D) ranks (rank r at
    (r // D, r % D)), or (n,) for the ``px`` axis of a frame; the groups of
    its collectives; and a count of the collectives it ran
    (``stats``: calls and bytes, device and host)."""

    num_experts: int
    shape: Tuple[int, ...]
    rank: int
    axis_names: Tuple[str, ...] = ("expert", "data")
    world_group: Any = None
    data_group: Any = None  # the ranks that hold this rank's experts
    expert_group: Any = None  # the ranks of this rank's data index
    stats: dict = dataclasses.field(default_factory=lambda: {"collectives": 0, "bytes": 0})

    @classmethod
    def build(cls, num_experts: int, mesh_experts: int, mesh_data: int = 1) -> "Mesh":
        """The mesh of E × D ranks over the process group, with its process
        groups (every rank must build the same meshes in the same order)."""
        E, D = int(mesh_experts), int(mesh_data)
        if num_experts % E:
            raise ValueError(f"{E} expert ranks do not divide K = {num_experts}")
        world, rank = world_rank()
        if world != E * D:
            raise ValueError(f"a mesh of {E} × {D} ranks needs {E * D} processes, "
                             f"this run has {world}")
        data = [dist.new_group([e * D + d for d in range(D)]) for e in range(E)]
        expert = [dist.new_group([e * D + d for e in range(E)]) for d in range(D)]
        return cls(num_experts=int(num_experts), shape=(E, D), rank=rank,
                   world_group=dist.group.WORLD, data_group=data[rank // D],
                   expert_group=expert[rank % D])

    @property
    def size(self) -> int:
        return int(math.prod(self.shape))

    @property
    def expert_index(self) -> int:
        return self.rank // self.shape[-1] if len(self.shape) == 2 else self.rank

    @property
    def data_index(self) -> int:
        return self.rank % self.shape[1] if len(self.shape) == 2 else 0

    @property
    def k0(self) -> int:
        return self.expert_index * self.num_experts // self.shape[0]

    @property
    def k1(self) -> int:
        return (self.expert_index + 1) * self.num_experts // self.shape[0]

    def task_range(self, T: int) -> Tuple[int, int]:
        """This rank's tasks of each expert: data index d of D takes
        [d·T // D, (d + 1)·T // D), so an uneven split gives the later ranks
        the extra tasks, and a rank past T none."""
        D = self.shape[1] if len(self.shape) == 2 else 1
        d = self.data_index
        return d * T // D, (d + 1) * T // D

    # ------------------------------------------------------ collectives

    def all_reduce(self, tensors: List[torch.Tensor], group, op=None) -> None:
        """Sum (or ``op``) ``tensors`` in place over ``group``: one
        ``all_reduce`` per dtype, the tensors packed into one buffer."""
        op = dist.ReduceOp.SUM if op is None else op
        by_dtype = {}
        for t in tensors:
            by_dtype.setdefault(t.dtype, []).append(t)
        for ts in by_dtype.values():
            flat = torch.cat([t.reshape(-1) for t in ts]) if len(ts) > 1 else ts[0].reshape(-1)
            dist.all_reduce(flat, op=op, group=group)
            self.stats["collectives"] += 1
            self.stats["bytes"] += flat.numel() * flat.element_size()
            if len(ts) == 1 and flat.data_ptr() == ts[0].data_ptr():
                continue  # reduced in place
            off = 0
            for t in ts:
                t.copy_(flat[off:off + t.numel()].view_as(t))
                off += t.numel()

    def gather_experts(self, local: torch.Tensor) -> torch.Tensor:
        """The full (K, ...) tensor from each expert rank's (K/E, ...) slice,
        over this rank's expert group (an ``all_reduce`` of a zero-filled
        tensor: each rank writes its own rows)."""
        full = local.new_zeros((self.num_experts, *local.shape[1:]))
        full[self.k0:self.k1] = local
        self.all_reduce([full], self.expert_group)
        return full

    def any_host(self, flag: bool) -> bool:
        """True on every rank when ``flag`` is true on one (over the host
        group: no wait for the card)."""
        t = torch.tensor([1 if flag else 0], dtype=torch.int32)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=_HOST_GROUP)
        self.stats["host_collectives"] = self.stats.get("host_collectives", 0) + 1
        return bool(t.item())

    def all_gather_host(self, t: torch.Tensor) -> List[torch.Tensor]:
        """Every slot's copy of the host tensor ``t`` (same shape on each),
        in rank order."""
        t = t.contiguous()
        out = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(out, t, group=_HOST_GROUP)
        self.stats["host_collectives"] = self.stats.get("host_collectives", 0) + 1
        self.stats["host_bytes"] = self.stats.get("host_bytes", 0) + t.numel() * t.element_size() * self.size
        return out


def check_mesh(mesh) -> None:
    """Refuse a ``mesh=`` that is neither None nor a ``Mesh``."""
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"mesh: a parallel.mesh.Mesh or None, not {type(mesh).__name__}")


def make_mesh(num_experts: int, mesh_experts: Optional[int] = None,
              mesh_data: int = 1) -> Optional[Mesh]:
    """The (expert, data) mesh over the process group's ranks, shaped as
    ``mesh_shape`` shapes it; None for one rank (no sharding needed). Every
    rank must call it, in the same order as its other meshes."""
    n, _ = world_rank()
    if n == 1:
        return None
    E, D = mesh_shape(num_experts, n, mesh_experts, mesh_data)
    return Mesh.build(num_experts, E, D)


def make_render_mesh() -> Optional[Mesh]:
    """Every rank on one ``px`` axis, for the frame's row blocks (parameters
    whole on every rank, blocks disjoint); None for one rank."""
    n, rank = world_rank()
    if n == 1:
        return None
    return Mesh(num_experts=0, shape=(n,), rank=rank, axis_names=("px",),
                world_group=dist.group.WORLD)


# ---------------------------------------------------------------- sharding


def _slice_experts(x, mesh: Mesh, num_experts: int):
    if not hasattr(x, "shape") or len(x.shape) == 0 or x.shape[0] != num_experts:
        raise ValueError(f"an expert leaf must lead with K = {num_experts}, has shape "
                         f"{tuple(getattr(x, 'shape', ()))}")
    out = x[mesh.k0:mesh.k1]
    return out.clone() if isinstance(out, torch.Tensor) else out.copy()


def local_container(model, mesh: Mesh):
    """A ``Container`` of this rank's experts ``[k0, k1)`` (their parameters,
    centroids and boxes, copied) and the whole background head."""
    from acn_tpu_torch.models.container import Container

    k0, k1 = mesh.k0, mesh.k1
    params = model.params()
    own = lambda t: t.detach().clone()
    experts = tree_map(lambda t: t.detach()[k0:k1].clone(), params["experts"])
    bg = tree_map(own, params["bg_mlp"]) if "bg_mlp" in params else None
    return Container(dataclasses.replace(model.cfg, num_submodules=k1 - k0), experts, bg,
                     own(model.centroids[k0:k1]), own(model.expert_aabbs[k0:k1]),
                     own(model.global_aabb))


# the root keys whose every leaf is per expert
_PER_EXPERT_ROOTS = ("occ_states", "device_pools", "batch")


def _by_position(tree: Any, leaf, container) -> Any:
    """``tree`` with each leaf x replaced by ``leaf(x, per_expert)`` and
    each ``Container`` c by ``container(c)``. A leaf is per expert by its
    position: under a key "experts" at any depth, or under a root key
    "occ_states", "device_pools" or "batch"; a root value None stays None."""
    from acn_tpu_torch.models.container import Container

    def walk(x, per):
        if isinstance(x, Container):
            return container(x)
        if isinstance(x, dict):
            return {k: walk(v, per or k == "experts") for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(walk(v, per) for v in x)
        return leaf(x, per)

    if isinstance(tree, dict):
        return {k: (walk(v, k in _PER_EXPERT_ROOTS + ("experts",)) if v is not None else None)
                for k, v in tree.items()}
    return walk(tree, False)


def shard_by_expert_axis(tree: Any, mesh: Optional[Mesh], num_experts: int) -> Any:
    """This rank's slice of ``tree``, by position (``_by_position``): a
    ``Container`` (or the value under "model") becomes ``local_container``;
    every per-expert leaf (parameters and optimizer moments under
    "experts", the occupancy states, the device pools, the batch) keeps rows
    ``[k0, k1)`` (copied). Every other leaf stays whole (and is the same
    object). ``mesh=None`` returns the tree."""
    if mesh is None:
        return tree
    return _by_position(tree, lambda x, per: _slice_experts(x, mesh, num_experts) if per else x,
                        lambda c: local_container(c, mesh))


def expert_leaves(tree: Any) -> Tuple[list, list]:
    """(the per-expert tensor leaves of a gradient tree, every other tensor
    leaf), each in ``tree_leaves``' order."""
    ex, rest = [], []
    _by_position(tree, lambda x, per: (ex if per else rest).append(x)
                 if isinstance(x, torch.Tensor) else None, lambda c: None)
    return ex, rest


def tree_sq_norm(tree: Any, mesh: Optional[Mesh]) -> torch.Tensor:
    """Σ g² over every leaf of a gradient tree, in ``tree_leaves``' order;
    under a mesh the expert leaves' partial sum is summed over the expert
    group (every rank of a data group holds the same expert gradients) and
    the other leaves, whole on every rank, are added once."""
    if mesh is None:
        return sum(torch.sum(g * g) for g in tree_leaves(tree))
    ex, rest = expert_leaves(tree)
    part = sum(torch.sum(g * g) for g in ex) if ex else torch.zeros(
        (), device=rest[0].device)
    part = part.reshape(1).clone()
    mesh.all_reduce([part], mesh.expert_group)
    total = part[0]
    for g in rest:
        total = total + torch.sum(g * g)
    return total


def all_finite(tree: Any, mesh: Optional[Mesh]) -> torch.Tensor:
    """Every leaf finite, on every rank (a 0-dim bool tensor; under a mesh
    the flag is reduced over the world)."""
    finite = torch.stack([torch.isfinite(g).all() for g in tree_leaves(tree)]).all()
    if mesh is None:
        return finite
    bad = (~finite).to(torch.int32).reshape(1)
    mesh.all_reduce([bad], mesh.world_group, op=dist.ReduceOp.MAX)
    return bad[0] == 0


def gather_tree(tree: Any, mesh: Optional[Mesh], num_experts: int) -> Any:
    """The inverse of ``shard_by_expert_axis`` for a state of tensors (no
    batch): every per-expert leaf gathered over the expert group, a
    ``Container`` as its ``checkpoint.variables_of`` tree with full leaves.
    Every rank of the expert group must call it."""
    if mesh is None:
        return tree

    def container(x):
        p = x.params()
        out = {"params": {"experts": tree_map(lambda t: mesh.gather_experts(t.detach()),
                                              p["experts"])},
               "buffers": {"centroids": mesh.gather_experts(x.centroids),
                           "expert_aabbs": mesh.gather_experts(x.expert_aabbs),
                           "global_aabb": x.global_aabb}}
        if "bg_mlp" in p:
            out["params"]["bg_mlp"] = p["bg_mlp"]
        return out

    return _by_position(tree, lambda x, per: mesh.gather_experts(x.detach()) if per else x,
                        container)
