"""Process groups and the collectives the parallel tree learners call.

Port of the JAX package's ``parallel/mesh.py``.  The JAX package names axes
on a ``jax.sharding.Mesh`` and lets XLA route its ``psum``/``pmax``
collectives; here every shard is a process of a ``torch.distributed``
group, one card a process: ``nccl`` when the training device is CUDA,
``gloo`` on the CPU (and for several ranks sharing one card: NCCL refuses
two ranks on one GPU).  The bring-up rules are the JAX package's:
``set_network`` takes the reference's machine list (the first entry is
the coordinator, this process's rank is its own entry) and
``init_distributed`` takes the rank explicitly.

``ProcessMesh`` carries the group and one thin method per collective the
growers need (sum/max/min all-reduce, reduce-scatter over the leading
axis, all-gather, broadcast).  Without a process group each collective is
the identity.  Each call adds to the mesh's ``stats`` (collective calls
and bytes sent into them).
"""
from __future__ import annotations

import datetime
import os
import socket
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device

DATA_AXIS = "data"
FEATURE_AXIS = "feature"

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN}


@dataclass
class ProcessMesh:
    """One axis of ranks: the group (None: the default group, or no group
    at all when ``torch.distributed`` is not initialized), this process's
    rank in it, its size and the axis name."""
    group: Optional[object]
    rank: int
    size: int
    axis_name: str = DATA_AXIS
    stats: dict = field(default_factory=lambda: {"calls": 0, "bytes": 0})

    @property
    def active(self) -> bool:
        """Whether collectives go to a backend (a group exists)."""
        return dist.is_initialized()

    @property
    def backend(self) -> Optional[str]:
        return dist.get_backend(self.group) if self.active else None

    def comm_device(self) -> torch.device:
        """Where host data goes for a collective: the current card under
        ``nccl`` (which takes CUDA tensors only), the CPU otherwise."""
        if self.backend == "nccl":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device("cpu")

    def _count(self, t: torch.Tensor) -> None:
        self.stats["calls"] += 1
        self.stats["bytes"] += t.numel() * t.element_size()

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``op`` ("sum", "max" or "min") over the ranks, as a new tensor
        (``lax.psum``/``pmax``/``pmin``)."""
        if not self.active:
            return t
        out = t.contiguous().clone()
        self._count(out)
        dist.all_reduce(out, op=_OPS[op], group=self.group)
        return out

    def reduce_scatter(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over the ranks of ``t``, of which this rank keeps block
        ``rank`` of the leading axis (``lax.psum_scatter(..., tiled=True)``;
        the leading size must divide by the group's).  ``gloo`` has no
        reduce-scatter for CUDA tensors: there it is a sum all-reduce
        followed by taking the rank's block."""
        if t.shape[0] % self.size:
            raise ValueError(f"reduce_scatter: leading size {t.shape[0]} is "
                             f"not divisible by the group's {self.size}")
        if not self.active:
            return t
        w = t.shape[0] // self.size
        if self.backend == "gloo" and t.is_cuda:
            return self.all_reduce(t)[self.rank * w:(self.rank + 1) * w]
        src = t.contiguous()
        out = src.new_empty((w,) + tuple(src.shape[1:]))
        self._count(src)
        dist.reduce_scatter_tensor(out, src, group=self.group)
        return out

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """``[size, *t.shape]``: every rank's ``t`` in rank order."""
        if not self.active:
            return t[None]
        src = t.contiguous()
        parts = [torch.empty_like(src) for _ in range(self.size)]
        self._count(src)
        dist.all_gather(parts, src, group=self.group)
        return torch.stack(parts)

    def broadcast(self, t: torch.Tensor, src: int) -> torch.Tensor:
        """Rank ``src``'s ``t`` on every rank (``src`` is a rank of this
        mesh)."""
        if not self.active:
            return t
        out = t.contiguous().clone()
        self._count(out)
        dist.broadcast(out, src=self._global_rank(src), group=self.group)
        return out

    def gather_np(self, a) -> np.ndarray:
        """Every rank's numpy array ``a`` (same shape on every rank),
        stacked in rank order, exactly: it travels as its own dtype on the
        backend's device."""
        a = np.ascontiguousarray(a)
        if not self.active:
            return a[None]
        t = torch.from_numpy(a.reshape(-1).copy()).to(self.comm_device())
        return self.all_gather(t).cpu().numpy().reshape((self.size,)
                                                        + a.shape)

    def _global_rank(self, r: int) -> int:
        if self.group is None:
            return r
        return dist.get_global_rank(self.group, r)


@dataclass
class Mesh2D:
    """A (data, feature) grid of ranks: one ``ProcessMesh`` per axis."""
    data: ProcessMesh
    feature: ProcessMesh


def default_mesh(num_devices: Optional[int] = None,
                 axis_name: str = DATA_AXIS) -> ProcessMesh:
    """The 1-D mesh over every rank of the default group (one rank and no
    backend without a group).  A JAX mesh may take a prefix of the
    devices; a rank cannot sit out of its own group's collectives, so
    ``num_devices`` must be the world size."""
    if dist.is_initialized():
        rank, size = dist.get_rank(), dist.get_world_size()
    else:
        rank, size = 0, 1
    if num_devices is not None and num_devices != size:
        raise ValueError(f"requested {num_devices} devices, the process "
                         f"group has {size} ranks")
    return ProcessMesh(None, rank, size, axis_name)


def mesh_2d(num_data: int, num_feature: int) -> Mesh2D:
    """``(data, feature)`` grid over the world: rank ``r`` sits at row
    ``r // num_feature``, column ``r % num_feature``; each axis gets its own
    subgroups (``dist.new_group``, made by every rank in the same order)."""
    base = default_mesh()
    n = num_data * num_feature
    if n != base.size:
        raise ValueError(f"mesh {num_data}x{num_feature} needs {n} ranks, "
                         f"the process group has {base.size}")
    r = base.rank
    row, col = divmod(r, num_feature)
    if not dist.is_initialized():
        return Mesh2D(ProcessMesh(None, 0, 1, DATA_AXIS),
                      ProcessMesh(None, 0, 1, FEATURE_AXIS))
    data_group = feature_group = None
    for c in range(num_feature):       # the data axis: one group a column
        g = dist.new_group([i * num_feature + c for i in range(num_data)])
        if c == col:
            data_group = g
    for i in range(num_data):          # the feature axis: one group a row
        g = dist.new_group([i * num_feature + c for c in range(num_feature)])
        if i == row:
            feature_group = g
    return Mesh2D(ProcessMesh(data_group, row, num_data, DATA_AXIS),
                  ProcessMesh(feature_group, col, num_feature, FEATURE_AXIS))


def default_backend(device=None) -> str:
    """``nccl`` for a CUDA training device, ``gloo`` for the CPU
    (``device=None`` is the card, as for every entry point)."""
    return "nccl" if resolve_device(device).type == "cuda" else "gloo"


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     timeout_secs: Optional[int] = None,
                     backend: Optional[str] = None, device=None) -> None:
    """Bring up the process group (reference ``LGBM_NetworkInit``,
    ``application.cpp:167-202``): ``tcp://coordinator_address`` init,
    ``num_processes`` ranks, this one ``process_id``.  Left as None they
    come from the launcher's environment (``MASTER_ADDR``/``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``).  The backend is the caller's, else
    ``default_backend(device)``; a failed init raises, nothing switches
    backends.  Under ``nccl`` the process takes the card ``LOCAL_RANK``
    (else its rank modulo the cards) unless ``device`` names one."""
    backend = backend or default_backend(device)
    kw = {}
    if timeout_secs is not None:
        kw["timeout"] = datetime.timedelta(seconds=int(timeout_secs))
    if coordinator_address is None:
        init_method = "env://"
    else:
        init_method = f"tcp://{coordinator_address}"
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", 1))
    if process_id is None:
        process_id = int(os.environ.get("RANK", 0))
    if backend == "nccl":
        dev = torch.device(device) if device is not None else None
        if dev is None or dev.index is None:
            local = os.environ.get("LOCAL_RANK")
            idx = (int(local) if local is not None
                   else process_id % max(1, torch.cuda.device_count()))
        else:
            idx = dev.index
        torch.cuda.set_device(idx)
    dist.init_process_group(backend=backend, init_method=init_method,
                            world_size=int(num_processes),
                            rank=int(process_id), **kw)


def _machine_entries(machines):
    """The machine list as ``host[:port]`` strings: a comma-separated
    string, or a list; a set is sorted (each process's hash order would
    otherwise give each rank a different coordinator)."""
    if isinstance(machines, str):
        return [m.strip() for m in machines.split(",") if m.strip()]
    entries = [str(m).strip() for m in machines]
    if isinstance(machines, (set, frozenset)):
        entries = sorted(entries)
    return entries


def _is_local_addr(addr: str) -> bool:
    """A bind to ``addr`` succeeds exactly when it is a local interface's
    address (robust where the hostname maps elsewhere, as Debian's
    127.0.1.1 /etc/hosts entry does)."""
    try:
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            s.bind((addr, 0))
        return True
    except OSError:
        return False


def set_network(machines, local_listen_port: int = 12400,
                listen_time_out: int = 120,
                num_machines: Optional[int] = None,
                backend: Optional[str] = None, device=None) -> None:
    """Reference ``Booster.set_network``: bring up the process group from
    a machine list of ``host[:port]`` entries (a list, a set or a
    comma-separated string).  The FIRST entry is the coordinator; this
    process's rank is the index of the entry naming this host, matched by
    name or address, else by a bind probe.  Several entries on this host
    raise (name the ranks with ``init_distributed``); ``listen_time_out``
    is in minutes, as in the reference."""
    entries = _machine_entries(machines)
    if num_machines is None:
        num_machines = len(entries)
    hosts = [e.split(":")[0] for e in entries]
    coord_host = hosts[0]
    coord_port = (int(entries[0].split(":")[1]) if ":" in entries[0]
                  else local_listen_port)

    local_names = {socket.gethostname(), "localhost", "127.0.0.1"}
    try:
        local_names.add(socket.gethostbyname(socket.gethostname()))
    except OSError:
        pass
    addrs = []
    for h in hosts:
        try:
            addrs.append(socket.gethostbyname(h))
        except OSError:
            addrs.append(h)
    matches = [i for i, (h, a) in enumerate(zip(hosts, addrs))
               if h in local_names or a in local_names]
    if not matches:
        # only as a fallback: the whole 127/8 block is bindable, so
        # loopback lists of several entries must resolve by name above
        matches = [i for i, a in enumerate(addrs) if _is_local_addr(a)]
    if len(matches) > 1:
        raise ValueError(
            f"set_network: machine entries {[entries[i] for i in matches]} "
            "all resolve to this host; assign ranks explicitly with "
            "init_distributed(coordinator_address, num_processes, "
            "process_id)")
    if not matches:
        raise ValueError(
            f"set_network: none of the machine entries {hosts} resolves to "
            "this host; use init_distributed(coordinator_address, "
            "num_processes, process_id) to assign the rank explicitly")
    init_distributed(coordinator_address=f"{coord_host}:{coord_port}",
                     num_processes=num_machines, process_id=matches[0],
                     timeout_secs=int(listen_time_out) * 60,
                     backend=backend, device=device)


def free_network() -> None:
    """Reference ``LGBM_NetworkFree``: tear the process group down (no-op
    without one)."""
    if dist.is_initialized():
        dist.destroy_process_group()
