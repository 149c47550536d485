"""Elastic orchestration: detect a lost worker, relaunch the survivors
(port of ``detr_tensorflow_tpu/parallel/elastic.py``, pure Python, the same
``DETR_ELASTIC_*`` environment and the same ``Generation`` and
``ElasticRun`` records).

A ``torch.distributed`` process group has no fault tolerance: when one
rank dies, every other rank's next collective fails or hangs until its
timeout, and a replacement cannot join mid-run. The recovery unit is the
whole job generation, and this module owns that loop:

    launcher = ElasticLauncher(worker_argv, n_processes=4)
    result = launcher.run()

* spawn a generation: ``world`` worker processes, each told its rank,
  world size, coordinator and generation through ``DETR_ELASTIC_*``
  environment variables (workers call :func:`initialize_from_env`, which
  starts the process group through ``parallel/multihost.py``);
* watch: poll worker liveness; a nonzero exit (crash, OOM kill,
  preemption SIGKILL) marks its host lost;
* recover: tear the generation down (survivors hang in dead collectives:
  they get SIGTERM, then SIGKILL), shrink the world by the ranks that
  failed first, and relaunch. Workers restore the latest checkpoint, which
  holds the logical, unsharded state (``train/checkpoint.py``), so the
  smaller world resumes where the larger one stopped;
* finish: a generation where every worker exits 0 is success; more than
  ``max_restarts`` relaunches, or a world shrinking below
  ``min_processes``, fails the run.

Cascade containment: only the failures present in the FIRST poll that
observes any failure count as lost hosts; survivors crashing later on the
dead peer's collective are part of the teardown, not further losses. On a
cluster, give ``worker_argv`` a callable that targets the hosts still
reachable: the control loop is the same.
"""

from __future__ import annotations

import dataclasses
import os
import socket
import subprocess
import tempfile
import time
from typing import Callable, List, Optional, Sequence, Union

from . import multihost

ENV_COORDINATOR = "DETR_ELASTIC_COORDINATOR"
ENV_RANK = "DETR_ELASTIC_RANK"
ENV_WORLD = "DETR_ELASTIC_WORLD"
ENV_GENERATION = "DETR_ELASTIC_GENERATION"


@dataclasses.dataclass(frozen=True)
class ElasticContext:
    """A worker's identity within the current generation."""

    rank: int
    world: int
    generation: int
    coordinator: str


def from_env() -> Optional[ElasticContext]:
    """Read the launcher-provided identity; None outside a launcher."""
    if ENV_RANK not in os.environ:
        return None
    return ElasticContext(
        rank=int(os.environ[ENV_RANK]),
        world=int(os.environ[ENV_WORLD]),
        generation=int(os.environ.get(ENV_GENERATION, "0")),
        coordinator=os.environ[ENV_COORDINATOR],
    )


def initialize_from_env() -> Optional[ElasticContext]:
    """Worker-side: join this generation's distributed runtime.

    Call first thing. No-op (returns None) when not running under an
    :class:`ElasticLauncher`, so the same script runs standalone; at world
    size 1 no process group starts, as in the JAX package.
    """
    ctx = from_env()
    if ctx is None:
        return None
    if ctx.world > 1:
        multihost.initialize(
            ctx.coordinator, num_processes=ctx.world, process_id=ctx.rank
        )
    return ctx


@dataclasses.dataclass
class Generation:
    """Outcome of one spawned generation."""

    generation: int
    world: int
    returncodes: List[Optional[int]]
    failed_ranks: List[int]
    outputs: List[str]

    @property
    def ok(self) -> bool:
        return all(rc == 0 for rc in self.returncodes)


@dataclasses.dataclass
class ElasticRun:
    """Outcome of an :meth:`ElasticLauncher.run`."""

    success: bool
    generations: List[Generation]

    @property
    def final_world(self) -> int:
        return self.generations[-1].world if self.generations else 0


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class ElasticLauncher:
    """Run a multi-process job; on a lost worker, relaunch the rest.

    Args:
      worker_argv: the worker command (list of argv strings), or a
        callable ``(rank, world, generation) -> argv`` for per-host
        commands (SSH wrappers on a real cluster).
      n_processes: initial world size.
      min_processes: smallest acceptable world — a shrink below this
        fails the run instead of relaunching.
      max_restarts: relaunch budget across the whole run.
      env: extra environment for workers (merged over ``os.environ``;
        a ``None`` value unsets the variable).
      cwd: worker working directory.
      poll_interval: liveness poll period, seconds.
      grace: seconds between SIGTERM and SIGKILL at teardown.
      generation_timeout: optional wall-clock budget per generation —
        a worker that hangs (e.g. wedged in a dead collective the
        launcher cannot observe) is as lost as a dead one; on expiry
        the still-running ranks are marked failed and the generation
        relaunches without them.
    """

    def __init__(
        self,
        worker_argv: Union[Sequence[str],
                           Callable[[int, int, int], Sequence[str]]],
        n_processes: int,
        *,
        min_processes: int = 1,
        max_restarts: int = 3,
        env: Optional[dict] = None,
        cwd: Optional[str] = None,
        poll_interval: float = 0.25,
        grace: float = 5.0,
        generation_timeout: Optional[float] = None,
    ):
        self._argv = worker_argv
        self.n_processes = n_processes
        self.min_processes = min_processes
        self.max_restarts = max_restarts
        self.env = env or {}
        self.cwd = cwd
        self.poll_interval = poll_interval
        self.grace = grace
        self.generation_timeout = generation_timeout

    def argv_for(self, rank: int, world: int, generation: int):
        if callable(self._argv):
            return list(self._argv(rank, world, generation))
        return list(self._argv)

    def _spawn(self, world: int, generation: int):
        # NB: the port is bound-probed then released (unavoidable race:
        # the coordinator must bind it itself); a stolen port surfaces
        # as a failed generation and costs one restart.
        port = _free_port()
        procs, logs = [], []
        try:
            for rank in range(world):
                env = dict(os.environ)
                for k, v in self.env.items():
                    if v is None:
                        env.pop(k, None)
                    else:
                        env[k] = v
                env[ENV_COORDINATOR] = f"127.0.0.1:{port}"
                env[ENV_RANK] = str(rank)
                env[ENV_WORLD] = str(world)
                env[ENV_GENERATION] = str(generation)
                log = tempfile.NamedTemporaryFile(
                    mode="w+", suffix=f".g{generation}.r{rank}.log",
                    delete=False,
                )
                logs.append(log)
                procs.append(subprocess.Popen(
                    self.argv_for(rank, world, generation),
                    stdout=log, stderr=subprocess.STDOUT,
                    env=env, cwd=self.cwd,
                ))
        except BaseException:
            # A failed Popen for rank k must not orphan ranks 0..k-1
            # (they would wedge in initialize waiting for full world).
            self._teardown(procs)
            self._read_logs(logs)
            raise
        return procs, logs

    @staticmethod
    def _read_logs(logs) -> List[str]:
        outs = []
        for log in logs:
            log.flush()
            with open(log.name) as f:
                outs.append(f.read())
            log.close()
            os.unlink(log.name)
        return outs

    def _teardown(self, procs) -> None:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        deadline = time.monotonic() + self.grace
        for p in procs:
            if p.poll() is None:
                try:
                    p.wait(timeout=max(deadline - time.monotonic(), 0.1))
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()

    def run(self) -> ElasticRun:
        world = self.n_processes
        generations: List[Generation] = []
        restarts = 0
        while True:
            gen_idx = len(generations)
            procs, logs = self._spawn(world, gen_idx)
            failed_ranks: List[int] = []
            deadline = (
                time.monotonic() + self.generation_timeout
                if self.generation_timeout else None
            )
            while True:
                rcs = [p.poll() for p in procs]
                # Snapshot of failures in THIS poll: the lost hosts.
                # Later nonzero exits are collective-error cascades.
                failed_ranks = [
                    r for r, rc in enumerate(rcs)
                    if rc is not None and rc != 0
                ]
                if failed_ranks:
                    break
                if all(rc == 0 for rc in rcs):
                    break
                if deadline is not None and time.monotonic() > deadline:
                    # Hung workers are lost hosts the poll can't see.
                    failed_ranks = [
                        r for r, rc in enumerate(rcs) if rc is None
                    ]
                    break
                time.sleep(self.poll_interval)
            if failed_ranks:
                self._teardown(procs)
            generations.append(Generation(
                generation=gen_idx,
                world=world,
                returncodes=[p.poll() for p in procs],
                failed_ranks=failed_ranks,
                outputs=self._read_logs(logs),
            ))
            if not failed_ranks:
                return ElasticRun(success=True, generations=generations)
            restarts += 1
            if restarts > self.max_restarts:
                return ElasticRun(success=False, generations=generations)
            world = world - len(failed_ranks)
            if world < self.min_processes:
                return ElasticRun(success=False, generations=generations)
