"""Process-group bootstrap, local rank launch and the leader's broadcast
(counterpart of ``esac_tpu/parallel/multihost.py``).

The JAX package initializes ``jax.distributed`` once per host and drives
every device of the mesh from one controller.  Here every rank is a
process with one device, so three pieces stand in for it:

- :func:`initialize_multihost` -- ``torch.distributed.init_process_group``
  from its arguments or from the ``torchrun`` environment (``MASTER_ADDR``,
  ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``).  The backend
  is explicit: NCCL when every rank has its own card, gloo on the CPU, and
  gloo for ranks that share one card (NCCL refuses two ranks on one
  device; gloo all-reduces CUDA tensors through host memory).  Asking NCCL
  for more ranks on a host than it has cards raises.
- :func:`spawn_ranks` -- N local ranks from one process
  (``torch.multiprocessing.spawn``), each initialized on a free localhost
  port; a rank that raises fails the call and the other ranks are ended.
- :func:`lead` / :func:`follow` -- the single-controller surface of the
  serving path: a collective function is called on rank 0 (where a
  dispatcher runs), which broadcasts the call's arguments to every other
  rank, whose :func:`follow` loop makes the same call.
"""

from __future__ import annotations

import datetime
import os
import socket
import threading

import torch
import torch.distributed as dist

from esac_tpu_torch.serve.gate import DISPATCH_GATE
from esac_tpu_torch.utils.precision import resolve_device

# How long a collective may wait for a rank before the group gives up.
TIMEOUT = datetime.timedelta(seconds=600)


def _env_int(name: str) -> int | None:
    v = os.environ.get(name)
    return None if v is None else int(v)


def initialize_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
    device=None,
) -> dict:
    """Initialize this rank's process group; call once per process.

    ``coordinator_address`` ("host:port"), ``num_processes`` and
    ``process_id`` default to the ``torchrun`` environment.  ``device``
    is the rank's device: None means the card, ``cuda:LOCAL_RANK``;
    ranks that share one card pass it explicitly ("cuda:0") with
    ``backend="gloo"``.  ``backend`` None means NCCL on the card and gloo
    on the CPU.  Returns the JAX package's summary dict
    {'process_index', 'process_count', 'local_devices',
    'global_devices'} plus 'backend' and 'device' (one device per rank, so
    the global device count is the world size)."""
    world = num_processes if num_processes is not None else _env_int("WORLD_SIZE")
    rank = process_id if process_id is not None else _env_int("RANK")
    if world is None or rank is None:
        raise ValueError("initialize_multihost: give num_processes and process_id, "
                         "or run under torchrun (WORLD_SIZE, RANK)")
    if device is None:
        device = f"cuda:{_env_int('LOCAL_RANK') or 0}"
    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("the NCCL backend runs on the card; use gloo on the CPU")
        local = _env_int("LOCAL_WORLD_SIZE") or world
        if local > torch.cuda.device_count():
            raise ValueError(
                f"NCCL needs one card per rank: {local} ranks on this host, "
                f"{torch.cuda.device_count()} card(s); ranks that share a card "
                "run on backend='gloo'")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if coordinator_address is None:
        init_method = "env://"
    else:
        init_method = f"tcp://{coordinator_address}"
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                            timeout=TIMEOUT, **kw)
    return {
        "process_index": dist.get_rank(),
        "process_count": dist.get_world_size(),
        "local_devices": 1,
        "global_devices": dist.get_world_size(),
        "backend": backend,
        "device": str(dev),
    }


def free_port() -> int:
    """A free TCP port on localhost (bound once, then released)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, fn, world, port, backend, device, args):
    if device is None and backend in (None, "nccl"):
        device = f"cuda:{rank}"  # one card per rank
    initialize_multihost(f"127.0.0.1:{port}", world, rank, backend, device)
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn, nprocs: int, args: tuple = (), backend: str | None = None,
                device=None) -> None:
    """Run ``fn(rank, *args)`` in ``nprocs`` new processes, each an
    initialized rank of one group on a free localhost port (``backend`` and
    ``device`` as :func:`initialize_multihost` takes them; every rank gets
    the same device -- "cpu", or the one card its ranks share -- and under
    NCCL with no device rank r runs on ``cuda:r``).  ``fn``
    must be importable by name (the processes start fresh).  Returns when
    every rank has returned; raises if any rank raised or died."""
    import torch.multiprocessing as mp

    mp.spawn(_rank_main, args=(fn, nprocs, free_port(), backend, device, args),
             nprocs=nprocs, join=True)


def _map_tensors(obj, fn):
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, dict):
        return {k: _map_tensors(v, fn) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_map_tensors(v, fn) for v in obj)
    return obj


def _broadcast(obj, device):
    """Rank 0's ``obj`` on every rank (tensors through host memory, then
    onto ``device``)."""
    box = [_map_tensors(obj, lambda t: t.detach().cpu()) if dist.get_rank() == 0 else None]
    kw = {"device": device} if dist.get_backend() == "nccl" else {}
    dist.broadcast_object_list(box, src=0, **kw)
    return _map_tensors(box[0], lambda t: t.to(device))


def lead(fn, device):
    """Rank 0's side of a collective ``fn``: the returned callable
    broadcasts its arguments to every rank (whose :func:`follow` makes the
    same call), then calls ``fn`` here.  ``.stop()`` ends the followers'
    loops.  Attributes of ``fn`` (``_cache_size``) stay reachable.

    Calls are serialized: a dispatcher may call from two threads at once
    (a watchdog's replacement worker beside a stalled dispatch, synchronous
    callers), and the followers replay calls one at a time, so one call's
    broadcast and collectives must not interleave with another's."""
    dev = torch.device(device)
    lock = threading.Lock()

    def call(*args, **kwargs):
        # A led call is a dispatch: the process's prefetch work yields to
        # it (serve/gate.py).  Inside a dispatcher's call it rides that
        # call's hold, which the SLO watchdog retires on a wedge.
        with DISPATCH_GATE.held(), lock:
            _broadcast((args, kwargs), dev)
            return fn(*args, **kwargs)

    def stop():
        with lock:
            _broadcast(None, dev)

    call.stop = stop
    if hasattr(fn, "_cache_size"):
        call._cache_size = fn._cache_size
    return call


def lead_if_distributed(fn, device):
    """:func:`lead` ``fn`` when the world has more than one rank (call on
    rank 0), else ``fn`` itself with a no-op ``.stop()``."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        if dist.get_rank() != 0:
            raise RuntimeError("a led serving function runs on rank 0; the other ranks "
                               "run parallel.follow")
        return lead(fn, device)
    fn.stop = lambda: None
    return fn


def follow(fn, device) -> int:
    """Every other rank's side of :func:`lead`: receive each call's
    arguments from rank 0 and make the call, until rank 0 stops.  Returns
    the number of calls made."""
    dev = torch.device(device)
    n = 0
    while True:
        msg = _broadcast(None, dev)
        if msg is None:
            return n
        args, kwargs = msg
        fn(*args, **kwargs)
        n += 1
