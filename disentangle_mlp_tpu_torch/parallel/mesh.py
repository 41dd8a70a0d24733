"""Data parallelism of the port (disentangle_mlp_tpu/parallel/mesh.py): the
counterpart of the JAX package's 1-D ``Mesh(('data',))``, parameters
replicated and the batch split along axis 0.

JAX drives every device from one process and XLA inserts the collectives.
The port runs one process per device (a *rank*), joined in a
``torch.distributed`` process group, and calls the collectives itself. The
contract is the JAX one: a step on W ranks equals the one-device step on the
whole global batch, to reduction order. BatchNorm takes its statistics over
the global batch (models/layers.py), each rank's loss is its exact share of
the global loss and the gradients are summed over the ranks (train/common.py),
every rank makes the same random draws and keeps its rows, and every rank
holds the same parameters after every step.

- :class:`Mesh`: the group's devices, one a rank, and, once joined, this
  process's rank, its process group and the backend: NCCL when every rank
  has a CUDA device of its own, gloo on the CPU and when ranks share a CUDA
  device (gloo stages CUDA tensors through the host). The backend follows
  from the devices and never changes.
- :func:`maybe_initialize_distributed`: joins the process group described by
  torchrun's environment (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``,
  ``RANK``, ``LOCAL_RANK``), as the JAX package reads
  ``JAX_COORDINATOR_ADDRESS``; nothing happens without it.
- :func:`make_mesh`: the mesh of ``n_devices`` (0 = every visible device)
  or of an explicit device list.
- :func:`spawn`: runs a function on every rank of a mesh that is not joined
  yet, one new process a rank (``torch.multiprocessing``, spawn start
  method); a one-device mesh joins in this process.
- :func:`replicate`, :func:`shard_batch`, :func:`all_reduce_sum` (a
  differentiable sum: its backward sums the gradients over the ranks),
  :func:`all_reduce_flat`, :func:`broadcast_` and :func:`all_gather_rows`.
"""

from __future__ import annotations

import os
import pickle
import socket
import threading
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from ..utils.runtime import float32_policy

DATA_AXIS = "data"


def backend_for(devices: Sequence[torch.device]) -> str:
    """NCCL when every rank has a CUDA device of its own, else gloo."""
    cuda = all(d.type == "cuda" for d in devices)
    distinct = len({str(d) for d in devices}) == len(devices)
    return "nccl" if cuda and distinct else "gloo"


class Mesh:
    """A 1-D data-parallel group: ``devices[r]`` is rank r's device. A mesh
    made by :func:`make_mesh` is not joined (``rank`` None) unless this
    process already is a rank of a torchrun launch; :func:`spawn` joins it
    on each rank. A joined mesh holds its process group (``group``): the
    collectives below go through it, never through a process-wide default,
    so meshes of one device can run side by side on threads of one process
    (the β search's groups)."""

    def __init__(self, devices: Sequence, rank: Optional[int] = None,
                 group=None):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.rank = rank
        self.backend = backend_for(self.devices)
        self.group = group

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def joined(self) -> bool:
        return self.rank is not None

    @property
    def device(self) -> torch.device:
        """This rank's device."""
        return self.devices[self.rank]

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def describe(self) -> str:
        return (f"{self.size} rank(s) on {', '.join(map(str, self.devices))}"
                f", backend {self.backend}")

    def join(self, rank: int, port: int) -> "Mesh":
        """This process as rank ``rank``, in a process group of its own
        (a TCP store on ``port`` of this host; an in-memory one for one
        rank), closed again by :meth:`leave`."""
        dev = self.devices[rank]
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        store = (dist.HashStore() if self.size == 1 else
                 dist.TCPStore("127.0.0.1", port, self.size, rank == 0))
        make = (dist.ProcessGroupNCCL if self.backend == "nccl"
                else dist.ProcessGroupGloo)
        return Mesh(self.devices, rank=rank,
                    group=make(store, rank, self.size))

    def leave(self) -> None:
        shutdown = getattr(self.group, "shutdown", None)
        if shutdown is not None:
            shutdown()
        self.group = None


def maybe_initialize_distributed(device="cuda") -> None:
    """Join the process group that torchrun's environment describes
    (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
    ``LOCAL_RANK``): NCCL on ``cuda:LOCAL_RANK`` for a CUDA ``device``,
    gloo on the CPU. Nothing happens without that environment or when the
    group exists already."""
    env = os.environ
    if dist.is_initialized() or not all(
            k in env for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE",
                               "RANK")):
        return
    world, rank = int(env["WORLD_SIZE"]), int(env["RANK"])
    local = int(env.get("LOCAL_RANK", rank))
    if torch.device(device).type == "cuda":
        if local >= torch.cuda.device_count():
            raise ValueError(
                f"LOCAL_RANK {local} but {torch.cuda.device_count()} visible "
                f"CUDA device(s): torchrun starts one process a device")
        torch.cuda.set_device(local)
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(
        backend, init_method=f"tcp://{env['MASTER_ADDR']}:"
                             f"{env['MASTER_PORT']}",
        world_size=world, rank=rank)


def _launched_mesh(device) -> Mesh:
    """The mesh of a torchrun launch, which this process has joined."""
    dev = (torch.device("cuda", torch.cuda.current_device())
           if torch.device(device).type == "cuda" else torch.device("cpu"))
    names: List[Optional[str]] = [None] * dist.get_world_size()
    dist.all_gather_object(names, str(dev))
    mesh = Mesh(names, rank=dist.get_rank(), group=dist.group.WORLD)
    if mesh.backend != dist.get_backend():
        raise RuntimeError(f"ranks on {names} need {mesh.backend}, the "
                           f"process group runs {dist.get_backend()}")
    return mesh


def make_mesh(n_devices: int = 0, devices: Optional[Sequence] = None,
              device="cuda") -> Mesh:
    """1-D data-parallel mesh over ``n_devices`` (0 = all visible): an
    explicit ``devices`` list, the ranks of a torchrun launch, the one
    device a CUDA ``device`` with an index names (``cuda:1``), the visible
    CUDA devices for ``cuda`` (asking for more raises, naming how many are
    visible), or ``n_devices`` CPU ranks."""
    if devices is not None:
        devs = [torch.device(d) for d in devices]
    elif dist.is_initialized():
        mesh = _launched_mesh(device)
        if n_devices and n_devices != mesh.size:
            raise ValueError(f"--mesh_shape {n_devices} in a launch of "
                             f"{mesh.size} processes")
        return mesh
    elif torch.device(device).index is not None:
        if n_devices > 1:
            raise ValueError(f"--mesh_shape {n_devices} on the one device "
                             f"{device}: pass --device cuda to spread over "
                             f"the visible devices")
        devs = [torch.device(device)]
    elif torch.device(device).type == "cuda":
        visible = torch.cuda.device_count()
        if n_devices > visible:
            raise ValueError(f"--mesh_shape {n_devices} asks for more "
                             f"devices than the {visible} visible CUDA "
                             f"device(s)")
        devs = [torch.device("cuda", i) for i in range(n_devices or visible)]
    else:
        devs = [torch.device("cpu")] * max(n_devices, 1)
    if n_devices and n_devices > 0:
        devs = devs[:n_devices]
    return Mesh(devs)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _worker(rank, fn, devices, port, conns, args, kwargs) -> None:
    float32_policy()  # a spawned rank starts with PyTorch's defaults
    if torch.device(devices[rank]).type == "cpu":
        # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // len(devices)))
    mesh = Mesh(devices).join(rank, port)
    try:
        out = fn(mesh, *args, **kwargs)
    finally:
        mesh.leave()
    # plain pickle: torch's reducers would hand over shared-memory handles
    # that die with this process
    conns[rank].send_bytes(pickle.dumps(out))


def spawn(fn: Callable, mesh: Mesh, *args, **kwargs) -> list:
    """``fn(joined_mesh, *args, **kwargs)`` on every rank of ``mesh``;
    returns the ranks' results in rank order. A one-device mesh joins in
    this process (a process group of one, closed again at the end);
    otherwise each rank is a new process
    (``torch.multiprocessing.start_processes``, spawn start method: ``fn``
    and the arguments are pickled) whose result comes back through a pipe.
    A rank that raises or dies ends the other ranks, and its traceback is
    raised here."""
    if mesh.joined:
        raise ValueError("the mesh is joined already: call fn on it")
    if mesh.size == 1:
        joined = mesh.join(0, 0)
        try:
            return [fn(joined, *args, **kwargs)]
        finally:
            joined.leave()
    ctx = torch.multiprocessing.get_context("spawn")
    pipes = [ctx.Pipe(duplex=False) for _ in mesh.devices]
    results: list = [None] * mesh.size

    def read(r: int) -> None:  # drains rank r's pipe while it runs
        try:
            results[r] = pickle.loads(pipes[r][0].recv_bytes())
        except EOFError:
            pass

    readers = [threading.Thread(target=read, args=(r,), daemon=True)
               for r in range(mesh.size)]
    for t in readers:
        t.start()
    procs = torch.multiprocessing.start_processes(
        _worker, args=(fn, [str(d) for d in mesh.devices], free_port(),
                       [w for _, w in pipes], args, kwargs),
        nprocs=mesh.size, join=False, start_method="spawn")
    try:
        while not procs.join():
            pass
    finally:
        for p in procs.processes:
            if p.is_alive():
                p.kill()
                p.join()
        for r, (parent_end, child_end) in enumerate(pipes):
            child_end.close()
            readers[r].join()
            parent_end.close()
    return results


# -- collectives ------------------------------------------------------------

class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks whose backward sums the incoming gradients over
    the ranks too: every rank's loss reaches every rank's input."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        group.allreduce([y]).wait()
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        ctx.group.allreduce([g]).wait()
        return g, None


def all_reduce_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Differentiable sum of ``x`` over the ranks."""
    return _AllReduceSum.apply(x, mesh.group)


def _by_dtype(tensors: Sequence[torch.Tensor]):
    """(indices, the tensors flattened into one buffer) per dtype."""
    groups: dict = {}
    for i, t in enumerate(tensors):
        groups.setdefault(t.dtype, []).append(i)
    for idx in groups.values():
        yield idx, torch.cat([tensors[i].reshape(-1) for i in idx])


def _split(flat: torch.Tensor, idx, tensors):
    """Views of ``flat`` shaped as ``tensors[i]`` for ``i`` in ``idx``."""
    at = 0
    for i in idx:
        n = tensors[i].numel()
        yield i, flat[at:at + n].view(tensors[i].shape)
        at += n


def all_reduce_flat(tensors: Sequence[torch.Tensor], mesh: Mesh
                    ) -> List[torch.Tensor]:
    """Each tensor summed over the ranks: one all-reduce per dtype of the
    tensors flattened together; returns the sums (views of the flat
    buffers), in order."""
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    for idx, flat in _by_dtype(tensors):
        mesh.group.allreduce([flat]).wait()
        for i, v in _split(flat, idx, tensors):
            out[i] = v
    return out


def broadcast_(tensors: Sequence[torch.Tensor], mesh: Mesh,
               src: int = 0) -> None:
    """Every tensor of ``tensors`` as rank ``src`` holds it, in place: one
    broadcast per dtype of the tensors flattened together."""
    with torch.no_grad():
        for idx, flat in _by_dtype(tensors):
            mesh.group.broadcast(flat, src).wait()
            for i, v in _split(flat, idx, tensors):
                tensors[i].copy_(v)


def all_gather_rows(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The ranks' ``t`` (equal shapes) concatenated along axis 0, in rank
    order."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(mesh.size)]
    mesh.group.allgather([parts], [t]).wait()
    return torch.cat(parts)


def replicate(tensors: Sequence[torch.Tensor], mesh: Mesh) -> None:
    """Every rank's state as rank 0 holds it (parameters, running
    statistics, optimizer state), in place."""
    broadcast_(list(tensors), mesh, 0)


def local_rows(n: int, mesh: Mesh) -> slice:
    """This rank's contiguous rows of ``n`` (``n`` divisible by the mesh)."""
    if n % mesh.size:
        raise ValueError(f"{n} rows do not split over {mesh.size} ranks")
    per = n // mesh.size
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def shard_batch(x: Any, mesh: Mesh) -> Any:
    """This rank's contiguous rows of a global batch."""
    return x[local_rows(x.shape[0], mesh)]
