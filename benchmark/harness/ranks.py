"""The ranks of a cell on several cards: one process per card, rank 0 the
process that ``run.py`` started, which starts the others and waits for
them; NCCL through a TCP store on localhost at a free port.

NCCL is kept from writing its shared-memory segments (``NCCL_SHM_DISABLE``):
the cards of one host talk over NVLink.
"""

from __future__ import annotations

import ctypes
import os
import signal
import socket
import subprocess
import sys
from typing import List

import torch


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _end_with_parent():
    """In a child before it runs: the kernel sends it SIGTERM when the
    process that started it ends (Linux's PR_SET_PDEATHSIG), so no rank
    outlives a rank 0 that was killed."""
    ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGTERM)


def spawn(argv: List[str], world: int, port: int) -> List[subprocess.Popen]:
    """Ranks 1..world-1 as children running ``argv`` with the rank's flags;
    their standard output goes to this process's standard error."""
    env = dict(os.environ, NCCL_SHM_DISABLE="1")
    return [subprocess.Popen(
        [sys.executable, *argv, "--rank", str(r), "--world", str(world),
         "--port", str(port)], stdout=sys.stderr, env=env,
        preexec_fn=_end_with_parent)
        for r in range(1, world)]


def wait(children: List[subprocess.Popen], timeout: float = 120.0) -> List[int]:
    codes = []
    for p in children:
        try:
            codes.append(p.wait(timeout=timeout))
        except subprocess.TimeoutExpired:
            p.kill()
            codes.append(p.wait())
    return codes


class Ranks:
    """This process's place in the cell's process group."""

    def __init__(self, rank: int, world: int, port: int,
                 device_type: str = "cuda"):
        import torch.distributed as dist

        os.environ["NCCL_SHM_DISABLE"] = "1"
        self.rank, self.world = rank, world
        if device_type == "cuda":
            torch.cuda.set_device(rank)
            self.device, backend = torch.device("cuda", rank), "nccl"
        else:
            # the CPU's stand-in, for tests: gloo
            self.device, backend = torch.device("cpu"), "gloo"
        dist.init_process_group(backend,
                                init_method=f"tcp://127.0.0.1:{port}",
                                rank=rank, world_size=world)
        self._dist = dist

    def agree(self, flag: bool) -> bool:
        """True on every rank where it is true on one."""
        t = torch.tensor([1.0 if flag else 0.0], device=self.device)
        self._dist.all_reduce(t, op=self._dist.ReduceOp.MAX)
        return bool(t.item())

    def cat(self, x):
        """Every rank's ``x`` concatenated along dim 0 in rank order (all
        ranks call it; shapes equal)."""
        x = x.detach().contiguous()
        parts = [torch.empty_like(x) for _ in range(self.world)]
        self._dist.all_gather(parts, x)
        return torch.cat(parts, dim=0)

    def objects(self, obj) -> list:
        out = [None] * self.world
        self._dist.all_gather_object(out, obj)
        return out

    def close(self):
        self._dist.barrier()
        self._dist.destroy_process_group()
