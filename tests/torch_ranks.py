"""Rank processes for the port's tests of parallelism (imports no JAX, so
the card's tests use it too).

``run_ranks`` writes a worker script to a test's ``tmp_path`` and starts one
process a rank: single-threaded (they must not take cores from the rest of
the suite), joined by Gloo through a file rendezvous in ``tmp_path`` (no
ports to race for between test workers), with a 60 s collective timeout;
every wait on them is bounded by WAIT_S.
"""

import os
import subprocess
import sys
import textwrap

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT_S = 120  # the longest wait on a rank process

# Prepended to every worker script: argv is rank, world, the output directory.
COMMON = textwrap.dedent('''
    import os, sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from detr_tensorflow_tpu_torch.parallel import make_mesh, multihost, shard_batch
    rank, world, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    assert multihost.initialize(init_method="file://" + os.path.join(out, "rendezvous"),
                                num_processes=world, process_id=rank, backend="gloo",
                                timeout_s=60)
    assert multihost.world_size() == world and multihost.is_primary() == (rank == 0)
''')


def run_ranks(script: str, world: int, out_dir, *args) -> list:
    """Run ``COMMON + script`` as ``world`` rank processes (argv: rank,
    world, ``out_dir``, ``args``); return their outputs. Every rank is
    killed if any runs past WAIT_S; a nonzero exit fails the test."""
    return start_ranks(script, world, out_dir, *args)()


def start_ranks(script: str, world: int, out_dir, *args):
    """``run_ranks`` without waiting: the ranks start now, and the returned
    function waits for them (bounded as in ``run_ranks``; again, it returns
    the same outputs) and returns their outputs. The caller may work
    meanwhile."""
    path = os.path.join(str(out_dir), "worker.py")
    with open(path, "w") as f:
        f.write(COMMON + textwrap.dedent(script))
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    env.pop("WORLD_SIZE", None)
    procs = [subprocess.Popen([sys.executable, "-u", path, str(r), str(world), str(out_dir),
                               *map(str, args)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, cwd=REPO, env=env)
             for r in range(world)]

    done = []

    def wait() -> list:
        if done:
            return done[0]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=WAIT_S)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        done.append(outs)
        for r, (p, out) in enumerate(zip(procs, outs)):
            assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{out[-4000:]}"
        return outs

    return wait


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """A test module's own torch work on one thread, as its ranks: beside the
    suite's other workers more threads only contend (autouse where
    imported)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
