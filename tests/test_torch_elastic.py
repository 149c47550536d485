"""Elastic relaunch (detr_tensorflow_tpu_torch/parallel/elastic.py and
``python -m detr_tensorflow_tpu_torch.elastic_launch``) against the JAX
package's launcher: the seven cases of tests/test_elastic.py.

Both launchers speak the same ``DETR_ELASTIC_*`` environment, so the same
worker runs under either. The scripted workers (no framework at all) run
through both launchers in one test and their outcomes are compared:
success, and each generation's number, world, failed ranks and status. The
lost-worker case also trains the tiny DETR of tests/test_torch_parallel.py
through the port's ``Trainer`` on Gloo (one thread a rank), checkpointing
every step; rank 1 of generation 0 dies after step 3's checkpoint, and the
relaunched world of one resumes at step 3 and trains to step 6. Every
process is bounded: the launchers tear a generation down on the first
failure, and ``run`` itself waits at most 120 s."""

import os
import subprocess
import sys

from detr_tensorflow_tpu_torch.parallel import elastic
from detr_tensorflow_tpu_torch.parallel.elastic import ElasticLauncher

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT_S = 120


def _launchers():
    from detr_tensorflow_tpu.parallel.elastic import ElasticLauncher as JaxLauncher

    return {"port": ElasticLauncher, "jax": JaxLauncher}


def _outcome(run):
    return run.success, [(g.generation, g.world, g.failed_ranks, g.ok) for g in run.generations]


def _both(argv, n, **kw):
    """The outcome of each launcher on the same worker, and the port's run."""
    runs = {name: cls(argv, n, **kw).run() for name, cls in _launchers().items()}
    assert _outcome(runs["port"]) == _outcome(runs["jax"])
    return runs["port"]


TRAIN_WORKER = r'''
import os, sys, time
import numpy as np
import torch
torch.set_num_threads(1)
from detr_tensorflow_tpu_torch.data import pad_targets
from detr_tensorflow_tpu_torch.parallel import elastic, make_mesh, shard_batch

ckpt_dir = sys.argv[1]
ctx = elastic.initialize_from_env()
assert ctx is not None
print(f"GEN {ctx.generation} RANK {ctx.rank} WORLD {ctx.world}", flush=True)
from detr_tensorflow_tpu_torch.models.detr import DETR
from detr_tensorflow_tpu_torch.train import (Trainer, TrainingConfig, restore_latest,
                                             save_checkpoint)

mesh = make_mesh(ctx.world) if ctx.world > 1 else None
torch.manual_seed(0)
model = DETR(num_classes=8, num_queries=6, model_dim=16, num_heads=2, num_encoder_layers=1,
             num_decoder_layers=1, dim_feedforward=32, backbone_stage_sizes=(1, 1, 1, 1),
             dropout=0.0)
config = TrainingConfig(background_class=7, train_backbone=True, train_transformers=True,
                        train_nlayers=True, batch_size=4, target_batch=None)
trainer = Trainer(model, config, seed=0, mesh=mesh)
if restore_latest(trainer, ckpt_dir) is not None:
    print(f"RESUMED {trainer.steps}", flush=True)
rng = np.random.default_rng(0)
boxes, classes, mask = zip(*(pad_targets(rng.uniform(0.2, 0.6, (n, 4)), np.ones(n, int), 6)
                             for n in (2, 2, 1, 3)))
batch = {"images": rng.normal(size=(4, 32, 32, 3)).astype(np.float32),
         "boxes": np.stack(boxes), "classes": np.stack(classes), "mask": np.stack(mask)}
local = shard_batch(batch, mesh)
while trainer.steps < 6:
    log = trainer.step(local)
    print(f"LOSS {trainer.steps} {float(log['total_loss']):.6f}", flush=True)
    save_checkpoint(trainer, ckpt_dir)  # every rank joins; its barrier is the crash point
    if ctx.generation == 0 and trainer.steps == 3:
        if ctx.rank == ctx.world - 1:
            print("DYING", flush=True)
            os._exit(17)  # a lost host, after step 3's checkpoint
        time.sleep(10)  # the survivor: seen alive by the poll that finds the loss
print("DONE", flush=True)
'''


def test_lost_worker_relaunch_resumes(tmp_path):
    """Two ranks train; rank 1 dies after step 3's checkpoint; the launcher
    tears generation 0 down and relaunches a world of one, which resumes
    at step 3 and finishes at step 6: JAX test_elastic.py's outcome, which
    the JAX launcher gives for a worker scripted to die so
    (``test_scripted_lost_worker_same_outcome``)."""
    worker = tmp_path / "worker.py"
    worker.write_text(TRAIN_WORKER)
    run = ElasticLauncher([sys.executable, "-u", str(worker), str(tmp_path / "ckpt")],
                          n_processes=2, min_processes=1, max_restarts=2,
                          env={"PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
                               "OMP_NUM_THREADS": "1", "WORLD_SIZE": None,
                               "DETR_DIST_TIMEOUT_S": "60"},
                          cwd=REPO, generation_timeout=WAIT_S / 2).run()
    assert run.success, [o[-2000:] for g in run.generations for o in g.outputs]
    assert _outcome(run) == (True, [(0, 2, [1], False), (1, 1, [], True)])
    g0, g1 = run.generations
    assert 17 in g0.returncodes and "DYING" in g0.outputs[1]
    assert "RESUMED 3" in g1.outputs[0] and "LOSS 6" in g1.outputs[0]
    assert "DONE" in g1.outputs[0] and "LOSS 4" not in g0.outputs[0]


def test_scripted_lost_worker_same_outcome(tmp_path):
    """The lost-worker case without a framework, through both launchers: the
    last rank of generation 0 exits 17 while the other waits; generation 1,
    a world of one, succeeds."""
    script = tmp_path / "die_once.py"
    script.write_text(
        "import os, sys, time\n"
        f"rank, gen = int(os.environ['{elastic.ENV_RANK}']), os.environ['{elastic.ENV_GENERATION}']\n"
        "if gen == '0':\n"
        "    if rank == 1:\n"
        "        sys.exit(17)\n"
        "    time.sleep(60)\n"
        "print('DONE')\n")
    run = _both([sys.executable, str(script)], 2, min_processes=1, max_restarts=2, grace=2.0)
    assert _outcome(run) == (True, [(0, 2, [1], False), (1, 1, [], True)])
    assert 17 in run.generations[0].returncodes and "DONE" in run.generations[1].outputs[0]


def test_from_env_roundtrip(monkeypatch):
    """The same environment names and context record as the JAX package's."""
    from detr_tensorflow_tpu.parallel import elastic as jax_elastic

    for name in ("ENV_COORDINATOR", "ENV_RANK", "ENV_WORLD", "ENV_GENERATION"):
        assert getattr(elastic, name) == getattr(jax_elastic, name)
    monkeypatch.delenv(elastic.ENV_RANK, raising=False)
    assert elastic.from_env() is None
    assert elastic.initialize_from_env() is None
    monkeypatch.setenv(elastic.ENV_COORDINATOR, "127.0.0.1:1234")
    monkeypatch.setenv(elastic.ENV_RANK, "2")
    monkeypatch.setenv(elastic.ENV_WORLD, "4")
    monkeypatch.setenv(elastic.ENV_GENERATION, "1")
    ctx = elastic.from_env()
    assert ctx == elastic.ElasticContext(rank=2, world=4, generation=1,
                                         coordinator="127.0.0.1:1234")
    assert ctx.__dict__ == jax_elastic.from_env().__dict__


def test_launcher_success_first_generation(tmp_path):
    script = tmp_path / "ok.py"
    script.write_text("print('fine')\n")
    run = _both([sys.executable, str(script)], 2)
    assert run.success and len(run.generations) == 1
    assert run.generations[0].ok and run.final_world == 2


def test_hung_worker_treated_as_lost(tmp_path):
    """A worker wedged forever is found by the generation timeout; the
    survivors relaunch without it."""
    script = tmp_path / "hang_once.py"
    script.write_text(
        "import os, time\n"
        f"if (os.environ['{elastic.ENV_GENERATION}'] == '0'\n"
        f"        and os.environ['{elastic.ENV_RANK}'] == '1'):\n"
        "    time.sleep(3600)\n"
        "print('fine')\n")
    run = _both([sys.executable, str(script)], 2, min_processes=1, max_restarts=1,
                generation_timeout=3.0, grace=2.0)
    assert run.success
    g0, g1 = run.generations
    assert g0.failed_ranks == [1] and not g0.ok
    assert g1.world == 1 and g1.ok


def test_cli_launcher_smoke(tmp_path):
    """``python -m detr_tensorflow_tpu_torch.elastic_launch`` on one worker:
    exit code 0 and the summary ``scripts/elastic_launch.py`` prints, line
    for line, for the JAX launcher's run of the same worker."""
    script = tmp_path / "ok.py"
    script.write_text("import os\n"
                      "print('rank', os.environ['DETR_ELASTIC_RANK'],\n"
                      "      'of', os.environ['DETR_ELASTIC_WORLD'])\n")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run([sys.executable, "-m", "detr_tensorflow_tpu_torch.elastic_launch",
                          "--nprocs", "2", "--", sys.executable, str(script)],
                         capture_output=True, text=True, env=env, cwd=REPO, timeout=WAIT_S)
    assert out.returncode == 0, out.stdout + out.stderr
    ref = _launchers()["jax"]([sys.executable, str(script)], 2).run()
    want = [f"generation {g.generation}: world={g.world} ok" for g in ref.generations]
    want.append(f"elastic run: SUCCESS (final world {ref.final_world})")
    assert out.stdout.splitlines() == want


def test_launcher_gives_up_after_max_restarts(tmp_path):
    """The highest rank dies early in every generation: one relaunch, at
    a world shrunk first, then failure."""
    script = tmp_path / "bad.py"
    script.write_text(
        "import os, sys, time\n"
        "rank, world = (int(os.environ['DETR_ELASTIC_RANK']),\n"
        "               int(os.environ['DETR_ELASTIC_WORLD']))\n"
        "if rank == world - 1:\n"
        "    time.sleep(0.5); sys.exit(3)\n"
        "time.sleep(60)\n")
    run = _both([sys.executable, str(script)], 2, min_processes=1, max_restarts=1, grace=2.0)
    assert not run.success
    assert len(run.generations) == 2 and run.generations[-1].world == 1


def test_launcher_fails_fast_below_min_processes(tmp_path):
    """Losing more workers than min_processes allows fails the run without
    a relaunch. Every worker fails, rank 0 first and the other long after
    (the launcher tears it down before): which ranks a poll sees lost does
    not hang on when the two launchers happen to poll, so their outcomes
    compare exactly."""
    script = tmp_path / "allbad.py"
    script.write_text(
        "import os, sys, time\n"
        f"time.sleep(0.3 if os.environ['{elastic.ENV_RANK}'] == '0' else 60)\n"
        "sys.exit(3)\n")
    run = _both([sys.executable, str(script)], 2, min_processes=2, max_restarts=3, grace=2.0)
    assert not run.success and len(run.generations) == 1
    assert run.generations[0].failed_ranks == [0]
