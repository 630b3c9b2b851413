"""A (dp, tp, sp) device mesh over ``torch.distributed``, the counterpart of
``pianobart_tpu/parallel/mesh.py``.

One process per rank (``torch.distributed.run`` starts them), each with its
device.  Rank r of a ``dp x tp x sp`` mesh sits at (dp, tp, sp) coordinates
in row-major order, as ``make_mesh`` reshapes its device list:
``r = (d * tp + t) * sp + s``.

* ``dp`` — data parallel: each rank takes its rows of the global batch;
* ``tp`` — tensor parallel: heads of every attention (TP∘SP, the
  reference's ``cfg.ring_tp_axis``), and the storage of the parameters
  whose logical axes :data:`LOGICAL_RULES` map to it;
* ``sp`` — sequence parallel: ring attention over the sequence axis
  (``ops/ring.py``).

Every rank builds the same process groups in the same order: one per ``sp``
ring, one per ``tp`` group, one per (dp, sp) gradient group (the ranks that
share a tp coordinate: the same shard of each tp-sharded parameter), and
one of the whole mesh, over which its ranks agree.  A group of one rank is
never built: its collectives are the identity; nor is one of the whole
world: its collectives run over the default group.

:func:`shard_params` places the parameters as the reference's
``shard_params`` does: each rank of a tp group stores only its slice of
the ``qkv``, ``mlp`` and ``vocab`` leaves (:data:`TP_PARAMS`), so their
gradients, AdamW moments and EMA shadow are slices too; every other
parameter is replicated.  The TP∘SP attention projects with its heads'
shards as they are; the FFN, the octuple table and the LM head gather
theirs where they are used (:func:`gather_param`), as the reference's
``shard_map`` takes the parameters as ``P()``.

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
           "all_reduce_grads_", "all_gather", "gather_shards", "shard_batch",
           "gather_batch", "put_batch_fn", "LOGICAL_RULES", "TP_PARAMS",
           "tp_layout", "shard_slice", "shard_params", "sharded_dims",
           "gather_param", "gather_state_dict", "shard_state_dict"]

AXES = ("dp", "tp", "sp")
# the process groups a mesh builds: the sp rings, the tp groups, the (dp, sp)
# gradient groups, and the whole mesh (its agreements)
_GROUPS = (("sp",), ("tp",), ("dp", "sp"), AXES)
AxisName = Union[str, Tuple[str, ...]]


@dataclasses.dataclass(frozen=True)
class Axis:
    """A mesh axis (or a product of axes) as one rank sees it: its process
    group (None for a group of one, or for the default group), its size,
    this rank's index in it, the global ranks of the group in index order,
    and the backend."""
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

    # -- agreement across the mesh -------------------------------------------
    def _flag_device(self) -> torch.device:
        # NCCL reduces device tensors only; gloo takes host tensors as they are
        return self.device if self.backend == "nccl" else torch.device("cpu")

    def agree_any(self, flag: bool) -> bool:
        """True on every rank when ``flag`` is true on any rank of the mesh
        (one all-reduce): a SIGTERM that reached one rank stops them all at
        the same step."""
        ax = self.axis(AXES)
        if ax.size == 1:
            return flag
        t = torch.tensor([1 if flag else 0], dtype=torch.int32,
                         device=self._flag_device())
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=ax.group)
        return bool(t.item())

    def agree(self, value: float) -> float:
        """The mesh's first rank's ``value`` on every rank (one broadcast): a
        decision taken from it (the best checkpoint, the patience count, an
        early stop) is the same on every rank."""
        ax = self.axis(AXES)
        if ax.size == 1:
            return value
        t = torch.tensor([value], dtype=torch.float64, device=self._flag_device())
        dist.broadcast(t, src=ax.ranks[0], group=ax.group)
        return float(t.item())

    def barrier(self) -> None:
        ax = self.axis(AXES)
        if ax.size == 1:
            return
        if self.backend == "nccl":
            dist.barrier(group=ax.group, device_ids=[self.device.index or 0])
        else:
            dist.barrier(group=ax.group)

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
            # a group of one, or of the whole world: the default group (None)
            build = 1 < len(members) < world
            group = dist.new_group(members) if build else None
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


def _gather_parts(t: torch.Tensor, ax: Axis) -> List[torch.Tensor]:
    """The members' tensors in index order, on ``t``'s device.  gloo
    gathers host tensors: a CUDA tensor goes through the host."""
    if ax.size == 1:
        return [t]
    src = t.contiguous()
    staged = ax.backend == "gloo" and src.is_cuda
    if staged:
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(ax.size)]
    dist.all_gather(parts, src, group=ax.group)
    return [p.to(t.device) for p in parts] if staged else parts


def all_gather(t: torch.Tensor, ax: Axis, dim: int) -> torch.Tensor:
    """The members' tensors concatenated along ``dim`` in index order."""
    if ax.size == 1:
        return t
    return torch.cat(_gather_parts(t, ax), dim)


class _GatherShards(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, dim):
        ctx.ax, ctx.dim, ctx.n = ax, dim, x.shape[dim]
        return all_gather(x, ax, dim)

    @staticmethod
    def backward(ctx, g):
        full = all_reduce_(g.contiguous().clone(), ctx.ax)
        return full.narrow(ctx.dim, ctx.ax.index * ctx.n, ctx.n), None, None


def gather_shards(x: torch.Tensor, ax: Axis, dim: int = 1) -> torch.Tensor:
    """Every member's shard of ``x`` concatenated along ``dim`` (the whole
    sequence on every rank of an sp ring), differentiably.  Forward: all-gather.
    Backward: the cotangents SUMMED over ``ax``, then this rank's slice (a
    reduce-scatter): the objective is the sum of the ranks' local losses, so
    a value every member reads takes every member's cotangent."""
    if ax.size == 1:
        return x
    return _GatherShards.apply(x, ax, dim)


# ---------------------------------------------------------------------------
# Batches
# ---------------------------------------------------------------------------

def shard_batch(mesh: Mesh, x):
    """This rank's dp rows and sp columns of a global ``(B, S, ...)`` batch
    (numpy or torch), as ``put_batch_fn``'s sharding places them.  Every
    rank reads the same global batch in the same order (no sampler)."""
    return mesh.cols(mesh.rows(x))


def gather_batch(mesh: Mesh, x: torch.Tensor, seq: bool = True) -> torch.Tensor:
    """The global batch from every rank's block of a per-rank result (the
    inverse of :func:`shard_batch`), in sample order: one all-gather over
    the (dp, sp) group, whose members stand in (dp, sp) row-major order.
    ``seq``: ``x`` is ``(B/dp, S/sp, ...)``; else ``(B/dp, ...)``, the same
    on every sp rank of a dp block (sp rank 0's is taken)."""
    parts = _gather_parts(x, mesh.axis(("dp", "sp")))
    sp = mesh.shape["sp"]
    return torch.cat([torch.cat(parts[d * sp:(d + 1) * sp], 1) if seq else parts[d * sp]
                      for d in range(mesh.shape["dp"])], 0)


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


# ---------------------------------------------------------------------------
# Parameters over tp (the counterpart of shard_params)
# ---------------------------------------------------------------------------

#: logical axis name -> mesh axis (None = replicate), the reference's rules
LOGICAL_RULES: Tuple[Tuple[str, Optional[str]], ...] = (
    ("batch", "dp"),
    ("seq", "sp"),
    ("embed", None),
    ("fused", None),
    ("qkv", "tp"),
    ("mlp", "tp"),
    ("vocab", "tp"),
)

#: Every parameter the reference annotates with logical axes: (the class
#: name of the module that owns it, its name under that module, the axes in
#: the torch tensor's dim order).  A flax ``Dense`` kernel ``(in, out)`` is
#: the torch ``weight (out, in)``, so its axes are swapped here.  The
#: parameters not listed carry no annotation there and are replicated: every
#: bias, the LayerNorms, ``LabelEmbedding`` (its ``table`` shares a name with
#: the octuple table), the classifier heads and the squeeze-excitation gate
#: (its ``fc1``/``fc2`` share names with the FFN's).
TP_PARAMS: Tuple[Tuple[str, str, Tuple[Optional[str], ...]], ...] = (
    ("MultiHeadAttention", "q_proj.weight", ("qkv", "embed")),
    ("MultiHeadAttention", "k_proj.weight", ("qkv", "embed")),
    ("MultiHeadAttention", "v_proj.weight", ("qkv", "embed")),
    ("MultiHeadAttention", "out_proj.weight", ("embed", "qkv")),
    ("FeedForward", "fc1.weight", ("mlp", "embed")),
    ("FeedForward", "fc2.weight", ("embed", "mlp")),
    ("OctupleEmbedding", "table", ("vocab", None)),
    ("OctupleEmbedding", "fusion.weight", ("embed", "fused")),
    ("PositionalEmbedding", "embedding", (None, "embed")),
    ("OctupleLMHead", "proj.weight", ("vocab", "embed")),
)


def tp_layout(model: torch.nn.Module) -> Dict[str, int]:
    """Parameter name -> the dim that :data:`LOGICAL_RULES` put on ``tp``,
    for every parameter of ``model`` that the rules shard (the modules
    matched by class, never by a parameter's name alone)."""
    rules = dict(LOGICAL_RULES)
    by_class: Dict[str, List[Tuple[str, int]]] = {}
    for cls, leaf, axes in TP_PARAMS:
        dims = [i for i, a in enumerate(axes) if a is not None and rules[a] == "tp"]
        if dims:
            by_class.setdefault(cls, []).append((leaf, dims[0]))
    out = {}
    for prefix, mod in model.named_modules():
        for leaf, dim in by_class.get(type(mod).__name__, ()):
            out[f"{prefix}.{leaf}" if prefix else leaf] = dim
    return out


def shard_slice(t: torch.Tensor, size: int, index: int, dim: int,
                name: str = "tensor") -> torch.Tensor:
    """Member ``index`` of ``size``'s contiguous slice of ``t`` along ``dim``
    (a ``NamedSharding``'s even split), a view; a dim that ``size`` does
    not divide raises, naming ``name``."""
    if t.shape[dim] % size:
        raise ValueError(f"{name}: dim {dim} of shape {tuple(t.shape)} is not "
                         f"divisible by the tp mesh axis ({size})")
    n = t.shape[dim] // size
    return t.narrow(dim, index * n, n)


def shard_params(model: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Replace every parameter of ``model`` that :func:`tp_layout` lists by
    this rank's contiguous tp slice (a new ``nn.Parameter`` holding a copy;
    the whole tensor is freed), marked with the dim it is split on
    (``tp_dim``).  Call it after any graft and before the optimizer and the
    EMA shadow are made, so they hold slices too.  At tp = 1 the model is
    returned as it is; a dim tp does not divide raises, naming the leaf."""
    tp = mesh.axis("tp")
    if tp.size == 1:
        return model
    layout = tp_layout(model)
    # every leaf checked before any is replaced
    cut = {name: shard_slice(model.get_parameter(name).detach(), tp.size, tp.index,
                             dim, name) for name, dim in layout.items()}
    for name, view in cut.items():
        owner, _, leaf = name.rpartition(".")
        mod = model.get_submodule(owner)
        q = torch.nn.Parameter(view.clone(),
                               requires_grad=getattr(mod, leaf).requires_grad)
        q.tp_dim = layout[name]
        setattr(mod, leaf, q)
    return model


def sharded_dims(model: torch.nn.Module) -> Dict[str, int]:
    """Name -> split dim of the parameters :func:`shard_params` replaced
    (empty for a whole model)."""
    return {n: p.tp_dim for n, p in model.named_parameters()
            if getattr(p, "tp_dim", None) is not None}


class _GatherParam(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, ax, dim):
        ctx.ax, ctx.dim, ctx.n = ax, dim, w.shape[dim]
        return all_gather(w, ax, dim)

    @staticmethod
    def backward(ctx, g):
        # a copy, also of a contiguous slice: the parameter's .grad must not
        # keep the whole gradient's storage alive
        return (g.narrow(ctx.dim, ctx.ax.index * ctx.n, ctx.n)
                .clone(memory_format=torch.contiguous_format), None, None)


def gather_param(p: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``p`` in ``dtype`` where a module uses it.  A tp shard
    (:func:`shard_params`) is cast first, then all-gathered over the active
    mesh's ``tp`` axis into the whole tensor; its backward is this rank's
    slice of the whole gradient, with no reduce: every tp rank computes the
    same replicated activations, so each already holds the whole gradient.
    A whole parameter is only cast."""
    dim = getattr(p, "tp_dim", None)
    if dim is None:
        return p.to(dtype)
    return _GatherParam.apply(p.to(dtype), axis("tp"), dim)


def gather_state_dict(sd: Dict[str, torch.Tensor], dims: Dict[str, int], ax: Axis
                      ) -> Dict[str, torch.Tensor]:
    """``sd`` with each entry named in ``dims`` all-gathered over ``ax``
    along its dim (the whole tensor, as on one rank), in ``sd``'s order;
    the others as they are.  A collective: every member of ``ax`` calls it
    with the same names."""
    return {name: all_gather(t, ax, dims[name]) if name in dims else t
            for name, t in sd.items()}


def shard_state_dict(sd: Dict[str, torch.Tensor], dims: Dict[str, int], size: int,
                     index: int) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`gather_state_dict`: each entry named in
    ``dims`` cut to member ``index`` of ``size``'s slice (a view)."""
    return {name: shard_slice(t, size, index, dims[name], name) if name in dims else t
            for name, t in sd.items()}
