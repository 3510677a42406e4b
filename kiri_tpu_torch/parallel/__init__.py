"""Data and tensor parallelism on ``torch.distributed``: the port of
``kiri_tpu/parallel/__init__.py``, one process per device.

* ``initialize``     — join the process group (torchrun's environment, or
                       the coordinator, process count and rank given), pin
                       this process's device;
* ``make_mesh``      — a (data, model) ``Mesh`` over the ranks, the model
                       axis innermost, so a tensor-parallel group is made of
                       consecutive ranks;
* ``param_spec``     — Megatron-style tensor-parallel rules for the
                       recognizer's torch parameter names;
* ``shard_variables`` / ``gather_variables`` — a model (or a state dict) to
                       this rank's shards, and a model back;
* ``local_batch_slice``, ``pad_batch_to_devices``, ``shard_batch_global`` —
                       this rank's rows of a global batch;
* autograd-aware collectives: ``copy_to_model`` (identity forward, all-reduce
  backward), ``reduce_from_model`` (all-reduce forward, identity backward),
  ``gather_from_model`` (the vocabulary-sharded heads' logits) and
  ``data_sum`` (a sum over the data axis whose backward sums too: global
  BatchNorm statistics, the detector loss's global terms).

Every collective on a tensor is an ``all_reduce`` (an all-gather is an
all-reduce of a zero-filled buffer in which each rank writes its slot), and
host objects go through ``all_gather_object``: gloo carries only
``broadcast`` and ``all_reduce`` for CUDA tensors, and gloo is how two ranks
share one card (NCCL refuses two ranks on one GPU). DTensor and
``torch.distributed.tensor.parallel`` are not used for the same reason.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"

_DEVICE: Optional[torch.device] = None


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None,
               device=None, store: Optional[dist.Store] = None
               ) -> torch.device:
    """Join the process group; returns this process's device.

    With no arguments the coordinator, world size and rank come from
    torchrun's ``MASTER_ADDR``/``MASTER_PORT`` (RuntimeError without
    them), ``WORLD_SIZE`` and ``RANK``;
    ``coordinator_address="host:port"``, ``num_processes`` and
    ``process_id`` give them explicitly. ``store`` (a
    ``torch.distributed.Store`` that some process already hosts) takes the
    coordinator's place: no rank then has to listen on a port of its own.
    ``device=None`` is the card
    ``cuda:LOCAL_RANK`` (``LOCAL_RANK`` from the environment, else the rank
    modulo the cards present), made current; ``"cuda:0"`` puts every rank on
    card 0; ``"cpu"`` runs on the CPU. ``backend`` defaults to ``"nccl"`` on
    the card and ``"gloo"`` on the CPU, and is never switched silently:
    ``backend="gloo"`` on the card is how two ranks share one card.
    """
    global _DEVICE
    env = os.environ
    if coordinator_address is None and store is None:
        if "MASTER_ADDR" not in env or "MASTER_PORT" not in env:
            raise RuntimeError(
                "parallel.initialize needs a coordinator: start the ranks "
                "with torchrun (MASTER_ADDR and MASTER_PORT), or pass "
                "coordinator_address, num_processes and process_id")
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    world = int(env.get("WORLD_SIZE", "1") if num_processes is None
                else num_processes)
    rank = int(env.get("RANK", "0") if process_id is None else process_id)
    if device is None:
        from ..device import resolve_device

        resolve_device(None)
        local = int(env.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        device = f"cuda:{local}"
    dev = torch.device(device)
    if dev.type == "cuda":
        from ..device import resolve_device

        resolve_device(dev)
        if dev.index is None:
            dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if store is not None:
        dist.init_process_group(backend, store=store, world_size=world,
                                rank=rank)
    else:
        dist.init_process_group(backend,
                                init_method=f"tcp://{coordinator_address}",
                                world_size=world, rank=rank)
    _DEVICE = dev
    return dev


def process_device() -> torch.device:
    """The device ``initialize`` pinned (the card when it was not called)."""
    return _DEVICE if _DEVICE is not None else torch.device("cuda")


def process_info() -> Tuple[int, int]:
    """(rank, world size) of this process; (0, 1) outside a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def shutdown() -> None:
    """Leave the process group, if one was joined."""
    global _DEVICE
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _DEVICE = None


class Mesh:
    """This rank's place on a (data, model) mesh of ranks: ``shape``
    {"data": D, "model": M}, its coordinates, and the process groups of its
    data axis (the ranks holding the same shards, over which gradients are
    summed) and of its model axis (the ranks splitting one replica). A group
    of one rank is None, and a collective over it does nothing."""

    def __init__(self, shape: Dict[str, int], rank: int,
                 data_group=None, model_group=None):
        self.shape = dict(shape)
        self.rank = rank
        self.data_index, self.model_index = divmod(rank, shape[MODEL_AXIS])
        self.data_group = data_group
        self.model_group = model_group

    @property
    def data_size(self) -> int:
        return self.shape[DATA_AXIS]

    @property
    def model_size(self) -> int:
        return self.shape[MODEL_AXIS]

    @property
    def size(self) -> int:
        return self.data_size * self.model_size

    def __deepcopy__(self, memo) -> "Mesh":
        return self   # process groups are not copied with a module

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank {self.rank} at data "
                f"{self.data_index}, model {self.model_index})")


def make_mesh(n_devices: Optional[int] = None,
              model_parallel: int = 1) -> Mesh:
    """A (data, model) mesh over the ranks of the process group, one device
    each: rank r sits at data r // model_parallel, model r %
    model_parallel. ``n_devices`` (default: the world size) must be the
    world size. Every rank must call this, in the same order as any other
    ``make_mesh``: it makes the axes' process groups."""
    rank, world = process_info()
    n = world if n_devices is None else int(n_devices)
    if n != world:
        raise ValueError(
            f"a mesh of {n} devices needs {n} ranks, one per device; this "
            f"run has {world} (start it with torchrun --nproc-per-node {n}, "
            "or call kiri_tpu_torch.parallel.initialize with the process "
            "count)")
    if n % model_parallel != 0:
        raise ValueError(f"{n} devices not divisible by "
                         f"model_parallel={model_parallel}")
    dp, mp = n // model_parallel, model_parallel
    data_group = model_group = None
    if mp > 1:
        for d in range(dp):
            g = dist.new_group([d * mp + m for m in range(mp)])
            if rank // mp == d:
                model_group = g
    if dp > 1:
        for m in range(mp):
            g = dist.new_group([d * mp + m for d in range(dp)])
            if rank % mp == m:
                data_group = g
    return Mesh({DATA_AXIS: dp, MODEL_AXIS: mp}, rank, data_group,
                model_group)


# ---------------------------------------------------------------------------
# Tensor-parallel rules
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class Spec:
    """Where a tensor's dimensions go: ``axes`` names a mesh axis (or None,
    replicated) per dimension in torch's layout. ``parts`` > 1: the sharded
    dimension packs that many equal blocks (q, k and v of an attention's
    ``in_proj``), each sharded on its own, so a shard is the same rows of
    every block."""
    axes: Tuple[Optional[str], ...]
    parts: int = 1

    @property
    def dim(self) -> Optional[int]:
        return self.axes.index(MODEL_AXIS) if MODEL_AXIS in self.axes else None


_HEADS = ("ctc_head.2.", "dec_head.", "lm_head.")


def param_spec(name: str, ndim: int) -> Spec:
    """Tensor-parallel spec of one recognizer tensor by its torch name:
    ``kiri_tpu.parallel._param_spec``'s rules with each axis flipped, since
    a torch weight is [out, in].

    * FFN: ``linear1`` sharded on its output (weight rows, bias),
      ``linear2`` on its input (weight columns);
    * attention: q, k and v sharded by heads (the rows of each third of
      ``in_proj_weight`` and ``in_proj_bias``), ``out_proj`` on its input;
    * the CTC projection, ``dec_head`` and ``lm_head`` on the vocabulary
      (weight rows, bias);
    * everything else (LayerNorm, the stem and its BatchNorm statistics, the
      embedding, ``mem_proj``, the biases of input-sharded layers)
      replicated.
    """
    if ndim == 0:
        return Spec(())
    if name.endswith(("attn.in_proj_weight", "attn.in_proj_bias")):
        return Spec((MODEL_AXIS,) + (None,) * (ndim - 1), parts=3)
    if name.endswith((".linear1.weight", ".linear1.bias")) or (
            name.startswith(_HEADS) and name.endswith((".weight", ".bias"))):
        return Spec((MODEL_AXIS,) + (None,) * (ndim - 1))
    if name.endswith((".linear2.weight", "attn.out_proj.weight")):
        return Spec((None, MODEL_AXIS))
    return Spec((None,) * ndim)


def _module_heads(variables) -> Tuple[Optional[int], Optional[int]]:
    return (getattr(variables, "enc_heads", None),
            getattr(variables, "dec_heads", None))


def _tensors(variables) -> Dict[str, torch.Tensor]:
    if isinstance(variables, torch.nn.Module):
        return dict(variables.state_dict())
    return {k: torch.as_tensor(v) for k, v in variables.items()}


def variable_shardings(variables, mesh: Mesh, enc_heads: Optional[int] = None,
                       dec_heads: Optional[int] = None) -> Dict[str, Spec]:
    """``param_spec`` of every tensor of a ``Recognizer`` (or a torch-named
    state dict), with ``kiri_tpu``'s fallback: a dimension that does not
    divide by the model axis is replicated. An attention is split by whole
    heads, so it is replicated too where its head count does not divide
    (``kiri_tpu`` lets XLA split such heads; the port keeps each head's
    attention on one device). A module's tensors fall back together, so a
    layer is either wholly sharded or wholly replicated."""
    mp = mesh.shape[MODEL_AXIS]
    if isinstance(variables, torch.nn.Module):
        enc_heads, dec_heads = _module_heads(variables)
    out = {}
    for name, t in _tensors(variables).items():
        spec = param_spec(name, t.dim())
        d = spec.dim
        if d is not None:
            ok = (t.shape[d] // spec.parts) % mp == 0
            if "attn." in name:
                heads = enc_heads if name.startswith("enc.") else dec_heads
                ok = ok and (heads is None or heads % mp == 0)
            if not ok:
                spec = Spec((None,) * t.dim())
        out[name] = spec
    return out


def local_shard(t: torch.Tensor, spec: Spec, index: int, size: int
                ) -> torch.Tensor:
    """Shard ``index`` of ``size`` of a whole tensor (itself when
    replicated)."""
    d = spec.dim
    if d is None or size == 1:
        return t
    blocks = t.unflatten(d, (spec.parts, -1))
    n = blocks.shape[d + 1] // size
    return blocks.narrow(d + 1, index * n, n).flatten(d, d + 1).contiguous()


def join_shards(pieces: Sequence[torch.Tensor], spec: Spec) -> torch.Tensor:
    """The whole tensor from its shards in model-axis order."""
    d = spec.dim
    if d is None or len(pieces) == 1:
        return pieces[0]
    return torch.cat([p.unflatten(d, (spec.parts, -1)) for p in pieces],
                     dim=d + 1).flatten(d, d + 1)


def shard_variables(variables, mesh: Mesh):
    """This rank's shards. A state dict gives a new dict of shards; a
    ``Recognizer`` gives a copy whose parameters are its shards and whose
    sharded attentions, FFNs and vocabulary heads carry the mesh (``tp``,
    ``tp_ffn``), which the forward reads to issue its collectives. A model
    already placed on this mesh is returned as it is."""
    specs = variable_shardings(variables, mesh)
    mp, m = mesh.model_size, mesh.model_index
    if not isinstance(variables, torch.nn.Module):
        return {k: local_shard(torch.as_tensor(v), specs[k], m, mp)
                for k, v in variables.items()}
    if getattr(variables, "mesh", None) is mesh:
        return variables
    import copy

    model = copy.deepcopy(variables)
    model.mesh = mesh
    model.shard_specs = specs
    if mp == 1:
        return model
    sharded = {k for k, s in specs.items() if s.dim is not None}
    for name in sharded:
        mod_name, _, leaf = name.rpartition(".")
        mod = model.get_submodule(mod_name)
        old = getattr(mod, leaf)
        new = local_shard(old.detach(), specs[name], m, mp)
        setattr(mod, leaf, torch.nn.Parameter(
            new, requires_grad=old.requires_grad))
        if leaf.startswith("in_proj") or mod_name.endswith(".out_proj"):
            model.get_submodule(mod_name.removesuffix(".out_proj")).tp = mesh
        elif mod_name.endswith((".linear1", ".linear2")):
            model.get_submodule(mod_name.rpartition(".")[0]).tp_ffn = mesh
        else:                                  # a vocabulary head
            mod.tp = mesh
    return model


def gather_tensor(t: torch.Tensor, group, size: int, index: int
                  ) -> List[torch.Tensor]:
    """Every rank's ``t`` (same shape) over ``group``, in group order: an
    all-reduce of a zero-filled buffer in which this rank fills its slot,
    in float32 (float64 for float64 and integer tensors, exact)."""
    if group is None or size == 1:
        return [t]
    wide = (torch.float64 if t.dtype in (torch.float64, torch.int64,
                                         torch.int32, torch.bool)
            else torch.float32)
    buf = torch.zeros((size,) + tuple(t.shape), dtype=wide, device=t.device)
    buf[index] = t.to(wide)
    dist.all_reduce(buf, group=group)
    return list(buf.to(t.dtype).unbind(0))


def gather_variables(model: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """``shard_variables``'s inverse for a ``Recognizer``: a copy with whole
    parameters and no mesh (a collective over the model axis: every rank
    calls it and gets them). A model that was never sharded is returned as
    it is."""
    import copy

    specs = getattr(model, "shard_specs", None)
    if specs is None:
        return model
    model = copy.deepcopy(model)
    for name, spec in specs.items():
        if spec.dim is None or mesh.model_size == 1:
            continue
        mod_name, _, leaf = name.rpartition(".")
        mod = model.get_submodule(mod_name)
        old = getattr(mod, leaf)
        whole = join_shards(gather_tensor(
            old.detach(), mesh.model_group, mesh.model_size,
            mesh.model_index), spec)
        setattr(mod, leaf, torch.nn.Parameter(
            whole, requires_grad=old.requires_grad))
    for mod in model.modules():
        for key in ("tp", "tp_ffn"):
            mod.__dict__.pop(key, None)
    model.__dict__.pop("mesh", None)
    model.__dict__.pop("shard_specs", None)
    return model


# ---------------------------------------------------------------------------
# Batches
# ---------------------------------------------------------------------------
def local_batch_slice(n_global: int, mesh: Optional[Mesh] = None
                      ) -> Tuple[int, int]:
    """This rank's contiguous rows [lo, hi) of a global batch: its block on
    the mesh's data axis (the ranks of one tensor-parallel group share
    their rows), or, without a mesh, its block among all processes as in
    ``kiri_tpu``. ``n_global`` must divide (pad first with
    ``pad_batch_to_devices``)."""
    if mesh is None:
        index, count = process_info()
    else:
        index, count = mesh.data_index, mesh.data_size
    if n_global % count != 0:
        raise ValueError(f"global batch {n_global} not divisible by "
                         f"{count}")
    per = n_global // count
    return index * per, (index + 1) * per


def pad_batch_to_devices(batch: Dict[str, Any], mesh: Mesh):
    """Zero rows appended to every array of the batch up to a multiple of
    the data-axis size, as ``kiri_tpu`` pads: (padded batch, rows before
    padding). Zero rows have no CTC label and only padding as decoder
    targets, so they add no loss term; like ``kiri_tpu``'s, they enter the
    stem's global BatchNorm statistics."""
    dp = mesh.shape[DATA_AXIS]
    arrays = [v for v in batch.values() if isinstance(v, np.ndarray)]
    n = arrays[0].shape[0]
    rem = (-n) % dp
    if rem == 0:
        return batch, n
    padded = {k: (np.concatenate([v, np.zeros((rem,) + v.shape[1:], v.dtype)])
                  if isinstance(v, np.ndarray) else v)
              for k, v in batch.items()}
    return padded, n


def shard_batch_global(batch: Dict[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """This rank's rows of the global batch that every rank holds (host
    arrays; 0-d values as they are)."""
    arrays = [v for v in batch.values() if np.ndim(v) > 0]
    lo, hi = local_batch_slice(len(arrays[0]), mesh)
    return {k: (v[lo:hi] if np.ndim(v) > 0 else v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# Autograd-aware collectives
# ---------------------------------------------------------------------------
def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over ``group`` in float32 (float64 stays float64), back in x's
    dtype."""
    wide = x.to(torch.float64 if x.dtype == torch.float64 else torch.float32)
    wide = wide.clone() if wide is x else wide
    dist.all_reduce(wide, group=group)
    return wide.to(x.dtype)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _SumOverGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, parts):
        ctx.mesh, ctx.parts = mesh, parts
        pieces = gather_tensor(x, mesh.model_group, mesh.model_size,
                               mesh.model_index)
        return join_shards(pieces, Spec((None,) * (x.dim() - 1)
                                        + (MODEL_AXIS,), parts))

    @staticmethod
    def backward(ctx, grad):
        spec = Spec((None,) * (grad.dim() - 1) + (MODEL_AXIS,), ctx.parts)
        return (local_shard(grad, spec, ctx.mesh.model_index,
                            ctx.mesh.model_size), None, None)


def copy_to_model(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The input of a layer sharded on its output: x as it is forward, the
    gradient summed over the model axis backward (Megatron's f)."""
    if mesh is None or mesh.model_size == 1:
        return x
    return _CopyToModel.apply(x, mesh.model_group)


def reduce_from_model(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The output of a layer sharded on its input: the partial sums added
    over the model axis forward, the gradient as it is backward (Megatron's
    g)."""
    if mesh is None or mesh.model_size == 1:
        return x
    return _ReduceFromModel.apply(x, mesh.model_group)


def gather_from_model(x: torch.Tensor, mesh: Optional[Mesh], parts: int = 1
                      ) -> torch.Tensor:
    """Logits of a vocabulary-sharded head: every rank's last dimension
    joined (``parts`` fused heads joined head by head); backward, this
    rank's slice of the gradient."""
    if mesh is None or mesh.model_size == 1:
        return x
    return _GatherFromModel.apply(x, mesh, parts)


def data_sum(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """x summed over the data axis, forward and backward: each rank's loss
    term that reads the sum gets the gradient of every rank's."""
    if mesh is None or mesh.data_size == 1:
        return x
    return _SumOverGroup.apply(x, mesh.data_group)


def data_sum_value(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """x summed over the data axis, without a gradient (counts, metrics)."""
    if mesh is None or mesh.data_size == 1:
        return x
    return _all_reduce(x.detach(), mesh.data_group)


def model_sum_value(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """x summed over the model axis, without a gradient."""
    if mesh is None or mesh.model_size == 1:
        return x
    return _all_reduce(x.detach(), mesh.model_group)


def _flat_collective(grads: Sequence[torch.Tensor], op) -> None:
    """``op`` on the tensors as one flat buffer, copied back in place."""
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    op(flat)
    o = 0
    for g in grads:
        g.copy_(flat[o: o + g.numel()].view_as(g))
        o += g.numel()


def sync_gradients(grads: Sequence[torch.Tensor], mesh: Optional[Mesh],
                   sharded: Sequence[bool] = ()) -> None:
    """Sum the gradients over the data axis in place, as one buffer (each
    rank's loss term is already scaled by the global counts). Over a model
    axis the gradients of replicated parameters (those not flagged in
    ``sharded``) are then taken from its first rank: the ranks compute them
    alike, but a scatter-add (the embedding's backward) may add in another
    order, and replicas that drift apart by a rounding would stay apart."""
    if mesh is None:
        return
    if mesh.data_size > 1:
        _flat_collective(grads, lambda t: dist.all_reduce(
            t, group=mesh.data_group))
    if mesh.model_size > 1:
        flags = list(sharded) + [False] * (len(grads) - len(sharded))
        first = mesh.rank - mesh.model_index
        _flat_collective([g for g, s in zip(grads, flags) if not s],
                         lambda t: dist.broadcast(t, first,
                                                  group=mesh.model_group))


def all_gather_objects(obj, group=None) -> List:
    """Every rank's host object over ``group`` (the world when None), in
    group order."""
    n = dist.get_world_size(group)
    out: List = [None] * n
    dist.all_gather_object(out, obj, group=group)
    return out
