"""A (dp, tp, sp) device mesh over ``torch.distributed``, the counterpart of
``pianobart_tpu/parallel/mesh.py``.

One process per rank (``torch.distributed.run`` starts them), each with its
device.  Rank r of a ``dp x tp x sp`` mesh sits at (dp, tp, sp) coordinates
in row-major order, as ``make_mesh`` reshapes its device list:
``r = (d * tp + t) * sp + s``.

* ``dp`` — data parallel: each rank takes its rows of the global batch;
* ``tp`` — tensor parallel: heads of every attention (TP∘SP, the
  reference's ``cfg.ring_tp_axis``);
* ``sp`` — sequence parallel: ring attention over the sequence axis
  (``ops/ring.py``).

Every rank builds the same process groups in the same order: one per ``sp``
ring, one per ``tp`` group, one per (dp, sp) gradient group (the ranks that
share a tp coordinate; under TP∘SP each tp rank holds the whole gradient
already).  A group of one rank is never built: its collectives are the
identity.  Parameters stay replicated on every rank, as the reference's
TP∘SP keeps them (``P()``).

:func:`use_mesh` is the counterpart of ``shard_map``'s axis environment: a
model whose config names a ring axis resolves it to a group of the active
mesh (:func:`axis`), and raises without one.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import os
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["Axis", "Mesh", "make_mesh", "single_device_mesh", "init_from_env",
           "parse_mesh", "use_mesh", "active_mesh", "axis", "all_reduce_",
           "all_reduce_grads_", "all_gather", "shard_batch", "put_batch_fn"]

AXES = ("dp", "tp", "sp")
# the process groups a mesh builds: the sp rings, the tp groups, the (dp, sp)
# gradient groups
_GROUPS = (("sp",), ("tp",), ("dp", "sp"))
AxisName = Union[str, Tuple[str, ...]]


@dataclasses.dataclass(frozen=True)
class Axis:
    """A mesh axis (or a product of axes) as one rank sees it: its process
    group (None for a group of one), its size, this rank's index in it, the
    global ranks of the group in index order, and the backend."""
    name: str
    group: Optional[dist.ProcessGroup]
    size: int
    index: int
    ranks: Tuple[int, ...]
    backend: str

    def peer(self, offset: int) -> int:
        """Global rank of the member ``offset`` places on in the ring."""
        return self.ranks[(self.index + offset) % self.size]


class Mesh:
    """This rank's view of a ``dp x tp x sp`` mesh: its coordinates, its
    device, and an :class:`Axis` for ``"tp"``, ``"sp"`` and the gradient
    group ``("dp", "sp")``.  Build it with :func:`make_mesh` (every
    rank of the world calls it) or :func:`single_device_mesh`."""

    def __init__(self, shape: Dict[str, int], rank: int, device: torch.device,
                 backend: str, axes: Dict[AxisName, Axis]):
        self.shape = dict(shape)
        self.rank = rank
        self.device = device
        self.backend = backend
        self.coords = dict(zip(AXES, _coords(rank, shape)))
        self._axes = axes

    def axis(self, name: AxisName) -> Axis:
        return self._axes[_key(name)]

    @property
    def distributed(self) -> bool:
        return dist.is_available() and dist.is_initialized()

    def __repr__(self) -> str:
        return (f"Mesh({self.shape['dp']}x{self.shape['tp']}x{self.shape['sp']}, "
                f"rank {self.rank} at {self.coords}, {self.device}, {self.backend})")

    # -- batch slicing (the counterpart of put_batch_fn's NamedSharding) --
    def rows(self, x):
        """This rank's dp rows of a global ``(B, ...)`` batch."""
        dp = self.shape["dp"]
        if x.shape[0] % dp:
            raise ValueError(
                f"batch size {x.shape[0]} not divisible by dp={dp}; pick "
                f"--batch_size k*dp or a smaller --mesh")
        n = x.shape[0] // dp
        return x[self.coords["dp"] * n:(self.coords["dp"] + 1) * n]

    def cols(self, x, dim: int = 1):
        """This rank's sp columns of a global ``(B, S, ...)`` tensor."""
        sp = self.shape["sp"]
        if x.shape[dim] % sp:
            raise ValueError(
                f"sequence length {x.shape[dim]} not divisible by sp={sp}; pick "
                f"--max_seq_len k*sp or a smaller --mesh")
        n = x.shape[dim] // sp
        return x.narrow(dim, self.coords["sp"] * n, n) if isinstance(
            x, torch.Tensor) else np.take(
                x, range(self.coords["sp"] * n, (self.coords["sp"] + 1) * n), dim)

    # -- agreement across the whole job --------------------------------------
    def _flag_device(self) -> torch.device:
        # NCCL reduces device tensors only; gloo takes host tensors as they are
        return self.device if self.backend == "nccl" else torch.device("cpu")

    def agree_any(self, flag: bool) -> bool:
        """True on every rank when ``flag`` is true on any rank of the job
        (one all-reduce over the world): a SIGTERM that reached one rank
        stops them all at the same step."""
        if not self.distributed:
            return flag
        t = torch.tensor([1 if flag else 0], dtype=torch.int32,
                         device=self._flag_device())
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return bool(t.item())

    def barrier(self) -> None:
        if not self.distributed:
            return
        if self.backend == "nccl":
            dist.barrier(device_ids=[self.device.index or 0])
        else:
            dist.barrier()

    def close(self) -> None:
        """Tear the process group down (every rank, at the end of a run)."""
        if self.distributed:
            dist.destroy_process_group()


def _coords(rank: int, shape: Dict[str, int]) -> Tuple[int, int, int]:
    tp, sp = shape["tp"], shape["sp"]
    return rank // (tp * sp), (rank // sp) % tp, rank % sp


def _key(name: AxisName) -> Tuple[str, ...]:
    key = (name,) if isinstance(name, str) else tuple(name)
    if not key or any(a not in AXES for a in key):
        raise ValueError(f"unknown mesh axis {name!r}; axes are {AXES}")
    return tuple(a for a in AXES if a in key)


def _group_ranks(shape: Dict[str, int], key: Tuple[str, ...]) -> List[List[int]]:
    """Every group of ``key`` (the ranks that share all other coordinates),
    each in index order, in one fixed order for every rank."""
    others = [a for a in AXES if a not in key]
    groups = []
    for fixed in itertools.product(*(range(shape[a]) for a in others)):
        at = dict(zip(others, fixed))
        members = []
        for free in itertools.product(*(range(shape[a]) for a in key)):
            at.update(zip(key, free))
            members.append((at["dp"] * shape["tp"] + at["tp"]) * shape["sp"] + at["sp"])
        groups.append(members)
    return groups


def make_mesh(dp: Optional[int] = None, tp: int = 1, sp: int = 1,
              device: Optional[Union[str, torch.device]] = None
              ) -> Optional[Mesh]:
    """The mesh over the first ``dp * tp * sp`` ranks of the initialized
    process group (``dp`` defaults to all the ranks ``tp * sp`` leaves), as
    ``make_mesh`` takes a device subset.  Every rank of the world must call
    it: each builds every group, in the same order.  Ranks outside the mesh
    get None.  Without a process group, the one-rank mesh."""
    if not (dist.is_available() and dist.is_initialized()):
        world, rank, backend = 1, 0, "none"
    else:
        world, rank, backend = dist.get_world_size(), dist.get_rank(), dist.get_backend()
    if dp is None:
        if world % (tp * sp):
            raise ValueError(f"{world} ranks not divisible by tp*sp={tp * sp}")
        dp = world // (tp * sp)
    shape = {"dp": dp, "tp": tp, "sp": sp}
    need = dp * tp * sp
    if need > world:
        raise ValueError(f"mesh {dp}x{tp}x{sp} needs {need} ranks, have {world}")
    axes: Dict[Tuple[str, ...], Axis] = {}
    for key in _GROUPS:
        for members in _group_ranks(shape, key):
            group = dist.new_group(members) if len(members) > 1 else None
            if rank in members:
                axes[key] = Axis("x".join(key), group, len(members),
                                 members.index(rank), tuple(members), backend)
    if rank >= need:
        return None
    device = torch.device(device) if device is not None else torch.device("cpu")
    return Mesh(shape, rank, device, backend, axes)


def single_device_mesh(device: Optional[Union[str, torch.device]] = None) -> Mesh:
    """The 1x1x1 mesh: no process group, every collective the identity."""
    device = torch.device(device) if device is not None else torch.device("cpu")
    one = {"dp": 1, "tp": 1, "sp": 1}
    axes = {key: Axis("x".join(key), None, 1, 0, (0,), "none") for key in _GROUPS}
    return Mesh(one, 0, device, "none", axes)


def parse_mesh(mesh: Optional[str], world: int) -> Tuple[int, int, int]:
    """``"dpxTPxSP"`` -> (dp, tp, sp); None -> every rank on dp, as the
    reference defaults to all devices on dp."""
    if not mesh:
        return world, 1, 1
    try:
        dp, tp, sp = (int(x) for x in mesh.lower().split("x"))
    except ValueError:
        raise ValueError(f"--mesh {mesh!r} is not dpxTPxSP (e.g. 2x1x2)") from None
    if min(dp, tp, sp) < 1:
        raise ValueError(f"--mesh {mesh!r}: every axis needs at least 1 rank")
    return dp, tp, sp


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


def init_from_env(mesh: Optional[str] = None, backend: str = "nccl",
                  device: Optional[Union[str, torch.device]] = None,
                  init_method: str = "env://") -> Mesh:
    """The process group and this rank's mesh from the variables
    ``torch.distributed.run`` sets (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``).

    The device is ``cuda:LOCAL_RANK % device_count`` unless ``device`` names
    another (``"cpu"``); without a card and without ``"cpu"`` it raises.
    ``nccl`` takes one rank per card: more ranks on this host than cards
    raises (NCCL would refuse them as "Duplicate GPU detected"); ranks that
    share a card run over ``gloo``.  A world of one rank builds no process
    group."""
    world = _env_int("WORLD_SIZE", 1)
    rank = _env_int("RANK", 0)
    local_rank = _env_int("LOCAL_RANK", 0)
    dp, tp, sp = parse_mesh(mesh, world)
    if dp * tp * sp != world:
        raise ValueError(f"--mesh {dp}x{tp}x{sp} needs {dp * tp * sp} ranks, "
                         f"the job has {world} (WORLD_SIZE)")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: nccl or gloo")
    if device is None or torch.device(device) == torch.device("cuda"):
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' "
                               "(--device cpu) to run on the CPU")
        device = torch.device("cuda", local_rank % torch.cuda.device_count())
    device = torch.device(device)
    if world > 1 and backend == "nccl":
        if device.type != "cuda":
            raise ValueError("the nccl backend runs on CUDA devices only; use "
                             "--dist_backend gloo with --device cpu")
        local = _env_int("LOCAL_WORLD_SIZE", world)
        if local > torch.cuda.device_count():
            raise ValueError(
                f"the nccl backend takes one rank per card: {local} ranks on "
                f"this host share {torch.cuda.device_count()} card(s) (NCCL "
                f"refuses them: \"Duplicate GPU detected\"); run them over "
                f"--dist_backend gloo, or start one rank per card")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if world == 1:
        return single_device_mesh(device)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world)
    return make_mesh(dp, tp, sp, device)


# ---------------------------------------------------------------------------
# The active mesh: shard_map's axis environment
# ---------------------------------------------------------------------------

# a stack, not a context variable: autograd runs backward (and the forward
# recomputed under checkpointing) on threads of its own, which must see it
_ACTIVE: List[Mesh] = []


@contextlib.contextmanager
def use_mesh(mesh: Mesh) -> Iterator[Mesh]:
    """Within the block, a model's ``cfg.ring_axis`` / ``cfg.ring_tp_axis``
    resolve to groups of ``mesh`` (:func:`axis`)."""
    _ACTIVE.append(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE.pop()


def active_mesh() -> Optional[Mesh]:
    return _ACTIVE[-1] if _ACTIVE else None


def axis(name: AxisName) -> Axis:
    """``name``'s axis of the active mesh; raises outside :func:`use_mesh`."""
    mesh = active_mesh()
    if mesh is None:
        raise RuntimeError(
            f"the model names mesh axis {name!r} (cfg.ring_axis / "
            f"cfg.ring_tp_axis) but no mesh is active: run it inside "
            f"pianobart_tpu_torch.parallel.mesh.use_mesh(mesh)")
    return mesh.axis(name)


# ---------------------------------------------------------------------------
# Collectives over an axis (the identity over a group of one)
# ---------------------------------------------------------------------------

def all_reduce_(t: torch.Tensor, ax: Axis) -> torch.Tensor:
    """SUM over ``ax`` in place.  gloo takes CUDA tensors for all-reduce
    (it stages them itself), NCCL device tensors."""
    if ax.size > 1:
        dist.all_reduce(t, group=ax.group)
    return t


def all_reduce_grads_(grads: Sequence[torch.Tensor], ax: Axis) -> None:
    """One SUM all-reduce over ``ax`` of the gradients flattened together
    (one per dtype), copied back in place."""
    if ax.size == 1 or not grads:
        return
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for g in grads:
        by_dtype.setdefault(g.dtype, []).append(g)
    for gs in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in gs])
        all_reduce_(flat, ax)
        torch._foreach_copy_(gs, [f.view_as(g) for f, g in zip(
            flat.split([g.numel() for g in gs]), gs)])


def all_gather(t: torch.Tensor, ax: Axis, dim: int) -> torch.Tensor:
    """The members' tensors concatenated along ``dim`` in index order.
    gloo gathers host tensors: a CUDA tensor goes through the host."""
    if ax.size == 1:
        return t
    src = t.contiguous()
    staged = ax.backend == "gloo" and src.is_cuda
    if staged:
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(ax.size)]
    dist.all_gather(parts, src, group=ax.group)
    out = torch.cat(parts, dim)
    return out.to(t.device) if staged else out


# ---------------------------------------------------------------------------
# Batches
# ---------------------------------------------------------------------------

def shard_batch(mesh: Mesh, x):
    """This rank's dp rows and sp columns of a global ``(B, S, ...)`` batch
    (numpy or torch), as ``put_batch_fn``'s sharding places them.  Every
    rank reads the same global batch in the same order (no sampler)."""
    return mesh.cols(mesh.rows(x))


def put_batch_fn(mesh: Mesh):
    """The runner's batch placement (the counterpart of ``put_batch_fn``):
    a global ``(B, S, 8)`` batch, refused when B does not divide by dp,
    moved whole to this rank's device.  The mesh steps corrupt the global
    batch, then take their block (:func:`shard_batch`)."""

    def put(b) -> torch.Tensor:
        b = np.asarray(b)
        if b.shape[0] % mesh.shape["dp"]:
            raise ValueError(
                f"batch size {b.shape[0]} not divisible by dp="
                f"{mesh.shape['dp']}; pick --batch_size k*dp or a smaller --mesh")
        return torch.as_tensor(b, device=mesh.device)

    return put
