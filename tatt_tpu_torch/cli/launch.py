"""Data-parallel training in D processes (the port's counterpart of the
JAX trainer's mesh, ``tatt_tpu/train/loop.py:91-101, 548-606``).

:func:`launch` starts ``world`` processes with ``torch.multiprocessing``'s
``spawn``; process r joins the process group as rank r on ``devices[r]``
(``cuda:r`` by default) and runs ``fn(rank, world, device, *args)``.  The
ranks meet through a ``file://`` rendezvous in a fresh temporary
directory.  When ``COORDINATOR_ADDRESS`` is set, this is host
``PROCESS_ID`` of ``NUM_PROCESSES`` hosts, as JAX's multi-host
``initialize`` reads them (``core/distributed.host_layout``): every host
launches its own ``world`` ranks, which take the global ranks
``PROCESS_ID * world + r`` of ``NUM_PROCESSES * world`` and meet through
:func:`~tatt_tpu_torch.core.distributed.initialize` at that address.  The
backend follows the device's type (``nccl`` on CUDA, ``gloo`` on the CPU)
unless ``backend`` says otherwise: two ranks sharing one card take
``gloo``, since NCCL refuses two ranks on one device.  Each rank runs one
CPU thread, sets the port's CUDA flags (``core/device.set_cuda_flags``:
no TF32) and takes the caller's ``torch.use_deterministic_algorithms``
setting.  A rank that fails ends the run: ``spawn``'s join raises and
stops the others.

:func:`train_worker` is the CLI's rank (``cli/main.py``): the training of
its flags on the rank's device.  Spawned functions live in the package, since
``spawn`` imports them by name in a fresh interpreter.
"""

from __future__ import annotations

import os
import tempfile
import time
from typing import Callable, Optional, Sequence, Union

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from tatt_tpu_torch.core import distributed
from tatt_tpu_torch.core.device import set_cuda_flags


def _entry(local: int, fn: Callable, world: int, devices: list, backend: Optional[str],
           init_method: Optional[str], timeout_s: float, deterministic: tuple, args: tuple) -> None:
    torch.set_num_threads(1)
    torch.use_deterministic_algorithms(deterministic[0], warn_only=deterministic[1])
    set_cuda_flags()
    device = devices[local]
    if device.type == "cuda":
        torch.cuda.set_device(device)
    hosts, host = distributed.host_layout()
    rank_id, size = host * world + local, hosts * world
    if init_method is None:
        distributed.initialize(num_processes=size, process_id=rank_id, device=device,
                               timeout_s=timeout_s, backend=backend)
    else:
        distributed.init_process(init_method, size, rank_id, device, backend, timeout_s)
    try:
        fn(rank_id, size, device, *args)
    finally:
        dist.destroy_process_group()


def launch(fn: Callable, world: int, args: tuple = (), devices: Optional[Sequence] = None,
           backend: Optional[str] = None, timeout_s: Optional[float] = None,
           deadline_s: Optional[float] = None) -> None:
    """Run ``fn(rank, world, device, *args)`` in ``world`` spawned ranks
    (``fn`` importable from the package) and wait for all of them; across
    hosts (module docstring) ``fn`` gets the global rank and world.
    ``devices``: one per rank of this host (default ``cuda:0`` ..
    ``cuda:world-1``); ``timeout_s``: the process group's (default
    ``distributed.GROUP_TIMEOUT_S``); ``deadline_s``: the whole run's
    (default none), past which every rank is killed and ``TimeoutError``
    raised.  A rank that raises or exits non-zero raises here."""
    devices = [torch.device(d) for d in (devices or [f"cuda:{r}" for r in range(world)])]
    if len(devices) != world:
        raise ValueError(f"{len(devices)} devices for {world} ranks")
    if any(d.type == "cuda" for d in devices) and not torch.cuda.is_available():
        raise RuntimeError("data-parallel ranks on CUDA devices and no CUDA device is available; "
                           "pass device='cpu' to run the plain PyTorch path")
    # "cuda" alone names the caller's current card
    devices = [torch.device("cuda", torch.cuda.current_device())
               if d.type == "cuda" and d.index is None else d for d in devices]
    timeout_s = distributed.GROUP_TIMEOUT_S if timeout_s is None else timeout_s
    deterministic = (torch.are_deterministic_algorithms_enabled(),
                     torch.is_deterministic_algorithms_warn_only_enabled())
    with tempfile.TemporaryDirectory(prefix="tatt_dp_") as tmp:
        init_method = (None if os.environ.get("COORDINATOR_ADDRESS")
                       else "file://" + os.path.join(tmp, "rendezvous"))
        ctx = mp.start_processes(
            _entry, args=(fn, world, devices, backend, init_method, timeout_s, deterministic,
                          tuple(args)),
            nprocs=world, join=False, start_method="spawn",
        )
        end = None if deadline_s is None else time.monotonic() + deadline_s
        while not ctx.join(None if end is None else max(end - time.monotonic(), 0.0)):
            if end is not None and time.monotonic() >= end:
                for p in ctx.processes:
                    p.kill()
                for p in ctx.processes:
                    p.join()
                raise TimeoutError(f"{world} data-parallel ranks did not finish in {deadline_s} s")


def run_in_turn(rank_id: int, world: int, device: torch.device, calls: list) -> None:
    """Each ``(fn, args)`` of ``calls`` in turn as this rank: several
    launch functions (importable from the package) in one spawn."""
    for fn, args in calls:
        fn(rank_id, world, device, *args)


def state_of(models: Sequence[Union[torch.nn.Module, dict]],
             optimizer: Union[torch.optim.Optimizer, dict]) -> dict:
    """name -> a CPU copy of each entry of the models' ``state_dict``s
    (``"<i>.<key>"``, modules or their ``state_dict``s) and of the
    optimizer's state by parameter index (``"adam<i>.<key>"``): one flat
    dict, to compare runs and ranks entry by entry."""
    sds = [m.state_dict() if isinstance(m, torch.nn.Module) else m for m in models]
    if isinstance(optimizer, torch.optim.Optimizer):
        optimizer = optimizer.state_dict()
    out = {f"{i}.{k}": v.detach().cpu().clone() for i, sd in enumerate(sds) for k, v in sd.items()}
    out.update({f"adam{i}.{k}": v.detach().cpu().clone() for i, st in optimizer["state"].items()
                for k, v in st.items() if torch.is_tensor(v)})
    return out


def train_worker(rank_id: int, world: int, device: torch.device, argvs: list,
                 out_dir: Optional[str] = None) -> None:
    """One rank of the CLI's training of each argv of ``argvs`` in turn on
    ``device`` (the CLI runs one; a check chains several runs in one
    launch).  With ``out_dir``, the rank writes ``rank<r>.<i>.pt`` there
    after the i-th: its models' and Adam's :func:`state_of`, ``iters``, the
    step metrics, the training's wall seconds, the process group's backend
    and the kernels' launches in this process so far.  A non-zero exit
    code raises SystemExit."""
    from tatt_tpu_torch.cli import main as cli
    from tatt_tpu_torch.kernels.gru import bigru_recurrence, bigru_recurrence_bwd
    from tatt_tpu_torch.kernels.lstm import bilstm_recurrence, bilstm_recurrence_bwd

    counters = {"bigru_fwd": bigru_recurrence, "bigru_bwd": bigru_recurrence_bwd,
                "bilstm_fwd": bilstm_recurrence, "bilstm_bwd": bilstm_recurrence_bwd}
    for i, argv in enumerate(argvs):
        cfg, opts = cli.parse_config(argv)
        code, trainer, result = cli.train(cfg, opts, device)
        if code:
            raise SystemExit(code)
        if out_dir is not None:
            torch.save({
                "state": state_of(trainer.generators + trainer.students, trainer.optimizer),
                "iters": trainer.iters,
                "metrics": result["metrics"],
                "seconds": result["seconds"],
                "backend": dist.get_backend(),
                "launches": {k: fn.launches for k, fn in counters.items()},
            }, os.path.join(out_dir, f"rank{rank_id}.{i}.pt"))
