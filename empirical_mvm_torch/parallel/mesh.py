"""Data parallelism across cards (counterpart of
``empirical_mvm_tpu/parallel/mesh.py``; ref: utils/dist.py, agent.py:195-201).

The reference runs one process per GPU (DDP / DeepSpeed ZeRO-1); the JAX
package runs one process over a 1-D ``data`` mesh, where the jitted step is
the one-device step on the global batch and XLA partitions every operation
that mixes rows. The port runs one process per card (``torch.distributed``,
launched by ``torch.distributed.run``) and keeps the JAX semantics:

* ``size_batch`` is the global batch. Rank r of W holds ``size_batch / W``
  rows, and its local row i is global row ``i * W + r`` (the loader's
  ``idx[r::W]`` split, :class:`~empirical_mvm_torch.data.loader.ShardedBatchLoader`).
* Inside :func:`data_parallel` (a context variable, so that the losses,
  the masking and the models under the step take no extra argument), every
  operation that mixes rows sees the global batch: draws are made at the
  global shape and each rank keeps its rows (:func:`local_rows`); features
  another row reads are gathered in global order (:func:`gather_rows`);
  loss denominators are global (:func:`global_sum`). Each rank's loss is
  then its share of the global loss, and the shares' gradients sum to the
  global gradient.
* :func:`reduce_gradients` sums the replicated parameters' gradients after
  backward in coalesced buckets; :func:`shard_model` with ``fsdp`` shards
  the swin blocks and BERT layers with ``torch.distributed.fsdp.fully_shard``
  (a library's collective scheduling, no kernel), whose reduce-scatter sums
  too. Parameter names are unchanged either way.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
from dataclasses import dataclass
from typing import Any, Iterable, Iterator

import torch
import torch.distributed as dist
from torch import nn

BUCKET_BYTES = 64 << 20     # gradient all-reduce bucket


@dataclass(frozen=True)
class DataParallel:
    """This process's place among the ranks of the default process group."""

    rank: int
    world: int


_ACTIVE: contextvars.ContextVar[DataParallel | None] = contextvars.ContextVar(
    "emvm_data_parallel", default=None)


def pad_batch(batch: dict[str, Any], target_b: int) -> tuple[dict[str, Any], int]:
    """Pad every tensor's leading dim to ``target_b`` by repeating the last
    row; returns (padded batch, n_valid). Other values (lists of ids) pass
    as they are. Used for eval tail batches."""
    def rows(x):
        return isinstance(x, torch.Tensor) and x.ndim > 0

    b = next(v for v in batch.values() if rows(v)).shape[0]
    if b == target_b:
        return batch, b
    if b > target_b:
        raise ValueError(f"a batch of {b} rows is larger than {target_b}")
    return {k: torch.cat([v] + [v[-1:]] * (target_b - b)) if rows(v) else v
            for k, v in batch.items()}, b


# ---------------------------------------------------------------- processes

def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def distributed_init(device="cuda") -> DataParallel | None:
    """Join the process group that ``torch.distributed.run`` describes
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` /
    ``MASTER_PORT``): NCCL on ``cuda:LOCAL_RANK``, gloo only where the
    caller asks for the CPU. Without that environment it does nothing and
    returns None (JAX ``distributed_init``; ref: utils/dist.py:20-75)."""
    if _initialized():
        return default_data_parallel()
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return None
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("NCCL needs a CUDA card and torch.cuda.is_available() is false")
        local = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(local)
        dist.init_process_group("nccl", rank=rank, world_size=world, device_id=local)
    else:
        dist.init_process_group("gloo", rank=rank, world_size=world)
    return DataParallel(rank, world)


def rank_device(device) -> torch.device:
    """The card of this rank (``cuda:LOCAL_RANK``), or ``device`` as given."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return device


def default_data_parallel() -> DataParallel | None:
    """The default process group's ranks, or None when there is none."""
    if not _initialized():
        return None
    return DataParallel(dist.get_rank(), dist.get_world_size())


def destroy() -> None:
    """Leave the process group, if this process is in one."""
    if _initialized():
        dist.destroy_process_group()


def process_count() -> int:
    return dist.get_world_size() if _initialized() else 1


def process_index() -> int:
    return dist.get_rank() if _initialized() else 0


def is_main_process() -> bool:
    """Rank 0 of ``torch.distributed`` when it is initialised, else true
    (ref: utils/dist.py:107-111)."""
    return process_index() == 0


def barrier() -> None:
    if _initialized():
        dist.barrier()


def per_rank_batch(batch_size: int, world: int) -> int:
    """Rows a rank holds of a global batch (JAX ``make_data_mesh``): a batch
    that does not divide over the ranks would leave some of them idle, or
    train them on uneven shares, so it is an error (the reference asserts
    per-GPU batch x world size for the same reason). One process per card
    cannot shrink its mesh as the JAX one does for a batch smaller than the
    device count, so that is an error too."""
    if batch_size % world or batch_size < world:
        raise ValueError(
            f"batch size {batch_size} does not divide across the {world} ranks — this "
            f"would silently idle cards. Pick a batch size divisible by the rank count.")
    return batch_size // world


def shard_batch(batch: dict[str, Any], dp: DataParallel | None) -> dict[str, Any]:
    """This rank's rows (``x[rank::world]``) of every tensor of a global
    batch, for callers that hold the whole batch (JAX ``shard_batch``);
    other values and 0-d tensors pass as they are."""
    if dp is None:
        return batch
    return {k: v[dp.rank::dp.world] if isinstance(v, torch.Tensor) and v.ndim else v
            for k, v in batch.items()}


# ---------------------------------------------------------------- the step's view

@contextlib.contextmanager
def data_parallel(dp: DataParallel | None) -> Iterator[None]:
    """Run the body with the global-batch semantics of ``dp`` (none when
    None): the draws, gathers and loss denominators below."""
    token = _ACTIVE.set(dp)
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def active() -> DataParallel | None:
    return _ACTIVE.get()


def global_rows(b: int) -> int:
    """The global batch of a step whose ranks hold ``b`` rows each."""
    dp = active()
    return b if dp is None else b * dp.world


def local_rows(x: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a tensor drawn at the global batch's shape."""
    dp = active()
    return x if dp is None else x[dp.rank::dp.world]


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum over ranks of a detached count or mask sum (a loss's
    denominator)."""
    dp = active()
    if dp is None:
        return x
    x = x.detach().clone()
    dist.all_reduce(x)
    return x


class _AllReduceSum(torch.autograd.Function):
    """The sum over ranks. Each rank's loss is its share, so the gradient of
    a rank's addend is the sum over ranks of the gradients of the sum."""

    @staticmethod
    def forward(ctx, x):
        x = x.clone()
        dist.all_reduce(x)
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g)
        return g


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over ranks (x itself outside :func:`data_parallel`),
    differentiable: train-mode BatchNorm's statistics of the global batch."""
    if active() is None:
        return x
    return _AllReduceSum.apply(x)


def _gather(x: torch.Tensor, world: int) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(world)]
    dist.all_gather(parts, x.contiguous())
    # rank-major (r, i) -> global order i * world + r
    return torch.stack(parts, dim=1).reshape(x.shape[0] * world, *x.shape[1:])


class _GatherRows(torch.autograd.Function):
    """Rows of every rank in global order. Each rank's loss is its share of
    the global loss, so a row's gradient is the sum over ranks of what the
    shares send it: the backward all-reduces, then keeps this rank's rows."""

    @staticmethod
    def forward(ctx, x, rank: int, world: int):
        ctx.rank, ctx.world = rank, world
        return _gather(x, world)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g)
        return g[ctx.rank::ctx.world].contiguous(), None, None


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every rank's rows of ``x`` in global order (x itself outside
    :func:`data_parallel`), through autograd where ``x`` needs a gradient."""
    dp = active()
    if dp is None:
        return x
    if x.requires_grad:
        return _GatherRows.apply(x, dp.rank, dp.world)
    with torch.no_grad():
        return _gather(x, dp.world)


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _buckets(tensors: list[torch.Tensor]) -> Iterator[list[torch.Tensor]]:
    by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        bucket, size = [], 0
        for t in group:
            bucket.append(t)
            size += t.numel() * t.element_size()
            if size >= BUCKET_BYTES:
                yield bucket
                bucket, size = [], 0
        if bucket:
            yield bucket


def all_reduce_coalesced(tensors: list[torch.Tensor]) -> None:
    """Sum ``tensors`` over ranks in place, one flat all-reduce a bucket."""
    for bucket in _buckets(tensors):
        flat = torch.cat([t.reshape(-1) for t in bucket])
        dist.all_reduce(flat)
        for t, v in zip(bucket, flat.split([t.numel() for t in bucket])):
            t.copy_(v.view_as(t))


def reduce_gradients(params: Iterable[torch.Tensor], dp: DataParallel | None) -> None:
    """Sum the gradients of the replicated parameters over ranks (the
    sharded ones were summed by their reduce-scatter)."""
    if dp is None:
        return
    all_reduce_coalesced([p.grad for p in params
                          if p.grad is not None and not _is_dtensor(p.grad)])


def reduce_losses(ls: dict[str, torch.Tensor], dp: DataParallel | None) -> dict:
    """Each rank's loss shares summed into the global losses (detached)."""
    vals = {k: v.detach() for k, v in ls.items()}
    if dp is None:
        return vals
    flat = torch.stack([v.float() for v in vals.values()])
    dist.all_reduce(flat)
    return dict(zip(vals, flat.unbind()))


# ---------------------------------------------------------------- parameters

def broadcast_parameters(model: nn.Module, dp: DataParallel | None) -> None:
    """Rank 0's parameters and buffers on every rank (before sharding)."""
    if dp is None or dp.world == 1:
        return
    with torch.no_grad():
        for t in list(model.parameters()) + list(model.buffers()):
            dist.broadcast(t.data, src=0)


def shard_model(model: nn.Module, dp: DataParallel | None, fsdp: bool = False,
                min_size: int = 2 ** 18) -> list[nn.Module]:
    """Replicated parameters (``fsdp`` off), or FSDP: ``fully_shard`` on
    every trained swin block and BERT layer of at least ``min_size``
    elements, each parameter split on its first dim over the ranks. Returns
    the sharded modules.

    The JAX rule (``param_shardings``) is per leaf: leaves under
    ``fsdp_min_size`` stay replicated, the others shard their largest
    divisible dim. FSDP2 shards a module's parameters together, so here the
    unit is the block or layer: one under ``min_size`` elements stays
    replicated, as do the embeddings, heads and norms outside the blocks
    and the frozen teachers. The root is not wrapped: the models' entry
    methods (``losses``, ``encode``, ``score_pairs``, the decoders) are not
    ``forward`` and call it inside, where FSDP2's root hooks would reshard
    the root's parameters mid-call. Every replicated parameter is summed by
    :func:`reduce_gradients`."""
    broadcast_parameters(model, dp)
    if dp is None or not fsdp:
        return []
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.fsdp import fully_shard

    from empirical_mvm_torch.models.bert import BertLayer
    from empirical_mvm_torch.models.video_swin import SwinTransformerBlock3D

    device = next(model.parameters()).device
    mesh = init_device_mesh(device.type, (dp.world,))
    units = []
    for m in model.modules():
        if not isinstance(m, (SwinTransformerBlock3D, BertLayer)):
            continue
        ps = list(m.parameters())
        if not all(p.requires_grad for p in ps) or sum(p.numel() for p in ps) < min_size:
            continue
        fully_shard(m, mesh=mesh, reshard_after_forward=True)
        m.set_gradient_divide_factor(1.0)       # a sum over ranks, as reduce_gradients
        m.set_force_sum_reduction_for_comms(True)
        units.append(m)
    return units


def full_tensor(x):
    """A sharded parameter or moment gathered whole (every rank must call);
    anything else as it is."""
    return x.full_tensor() if _is_dtensor(x) else x


def local_tensor(x):
    """This rank's shard of a sharded tensor (a view: writes land in it)."""
    return x.to_local() if _is_dtensor(x) else x


def fill_from_full(x: torch.Tensor, full) -> None:
    """Copy a whole tensor into ``x``, or into this rank's shard of it."""
    full = torch.as_tensor(full)
    with torch.no_grad():
        if _is_dtensor(x):
            from torch.distributed.tensor import distribute_tensor
            part = distribute_tensor(full.to(x.device, x.dtype), x.device_mesh, x.placements,
                                     src_data_rank=None).to_local()
            x.to_local().copy_(part)
        else:
            x.copy_(full.to(x.dtype))


def full_state_dict(model: nn.Module) -> dict[str, torch.Tensor]:
    """``model.state_dict()`` with every shard gathered (every rank must
    call)."""
    return {k: full_tensor(v) for k, v in model.state_dict().items()}


# ---------------------------------------------------------------- metrics

def all_gather_objects(obj) -> list:
    """Every rank's ``obj``, in rank order ([obj] on one process)."""
    if not _initialized() or dist.get_world_size() == 1:
        return [obj]
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def all_gather_metrics(values: list[float]) -> list[float]:
    """Every process's metric list, concatenated in rank order; the lists
    may differ in length (ref: utils/dist.py:187-227; JAX
    ``all_gather_metrics``): the identity on one process."""
    return [float(v) for part in all_gather_objects(list(values)) for v in part]
