"""Launch a multi-process training job with lost-worker recovery (twin of
the repository's ``scripts/elastic_launch.py``):

    python -m detr_tensorflow_tpu_torch.elastic_launch --nprocs 4 --min-procs 2 \\
        -- python -u my_train_script.py --checkpoint_dir /ckpts

Spawns N copies of the worker command; each worker joins the job with
``parallel.elastic.initialize_from_env()`` and should restore the latest
checkpoint at startup (``train.restore_latest``). When a worker dies, the
launcher tears the generation down and relaunches the survivors as a
smaller world (``parallel/elastic.py``).
"""

from __future__ import annotations

import argparse
import sys

from .parallel.elastic import ElasticLauncher


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--nprocs", type=int, required=True, help="initial world size")
    parser.add_argument("--min-procs", type=int, default=1,
                        help="smallest world worth relaunching at")
    parser.add_argument("--max-restarts", type=int, default=3, help="relaunch budget")
    parser.add_argument("--generation-timeout", type=float, default=None,
                        help="seconds before still-running workers are treated as hung "
                             "(lost) and relaunched without")
    parser.add_argument("worker", nargs=argparse.REMAINDER,
                        help="worker command (prefix with --)")
    args = parser.parse_args(argv)
    worker = args.worker
    if worker and worker[0] == "--":
        worker = worker[1:]
    if not worker:
        parser.error("worker command required after --")

    run = ElasticLauncher(
        worker, args.nprocs, min_processes=args.min_procs, max_restarts=args.max_restarts,
        generation_timeout=args.generation_timeout,
    ).run()
    for g in run.generations:
        status = "ok" if g.ok else f"lost ranks {g.failed_ranks}"
        print(f"generation {g.generation}: world={g.world} {status}")
        if not g.ok:
            for r in g.failed_ranks:
                print(f"--- rank {r} output tail ---\n{g.outputs[r][-1500:]}")
    print(f"elastic run: {'SUCCESS' if run.success else 'FAILED'} (final world {run.final_world})")
    return 0 if run.success else 1


if __name__ == "__main__":
    sys.exit(main())
