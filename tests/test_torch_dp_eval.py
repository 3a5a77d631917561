"""Data-parallel evaluation and the train CLI's data-parallel entry
points on the CPU.

One spawn for the module's evaluation: the fixture ``dp_eval`` starts two
gloo ranks (``parallel.launch``, joined within 50 s) that run
``cli.generate.run`` and ``cli.tournament.run`` (what ``--num_devices=2``
runs in each process) on three port runs (the BigGAN flagship's flags at
16^3, BN over the global batch; StyleGAN-1 at 8^3, its mixing permuting
the global batch and its D's minibatch-std groups crossing the ranks;
the msl DCGAN at 16^3, its D's crops drawn for the global batch), and
judge a fixed batch with each run's D; the tournament plays the two
16^3 runs; then ``cli.train.train_rank`` (what ``--num_devices=2`` runs in
each process) trains the flagship's flags at 16^3 2 steps with
``--track_energy`` and resumes to 3. Beside it, two processes run
the train CLI as two hosts (``--distributed=True --num_processes=2
--process_id=i --coordinator_address=localhost:<port>``, one rank
each). Checked against one device on the same global batch:

- the generated volumes and the D scores, atol 1e-5 (f32, other
  summation orders);
- the tournament's win rates, equal unless a fake's score lies within
  1e-4 of its largest score of the bound (a count that rounding may flip,
  as test_torch_eval_cli.py allows);
- rank 0 alone prints and writes (the train CLI's checkpoints and PNGs
  counted on each rank); ``--num_devices=0`` is one process on the CPU;
- the train CLI at 2 ranks: the replica check after each run (every
  parameter, buffer and Adam moment bit-equal to rank 0's), the resume,
  step 0's losses equal to the one-process run's (rtol 1e-5), and
  ``energy.json`` with the JAX ``EnergyTracker.summary()`` keys and 2
  chips;
- the two hosts: host 0 alone logs and writes the checkpoint, and the
  replica check after training passes across the hosts.
"""

import contextlib
import json
import os
import re
import socket
import subprocess
import sys
from argparse import Namespace
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from gan3d_tpu_torch.cli import generate, tournament
from gan3d_tpu_torch.eval.load import load_run, make_discriminator_fn
from gan3d_tpu_torch.parallel import dist

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOIN_TIMEOUT = 50.0
FAMILIES = {
    "biggan": (16, ["--biggan=True", "--hinge=True", "--filterG=8",
                    "--filterD=8", "--batch_size=4"]),
    "stylegan": (8, ["--stylegan=True", "--filterG=16", "--filterD=16",
                     "--batch_size=4"]),
    "msl": (16, ["--dcgan=True", "--msl=True", "--filterG=8", "--filterD=8",
                 "--batch_size=4"]),
}
TRAIN = ["--platform=cpu", "--z_size=8", "--niters=2",
         "--data_loader_workers=1", "--compute_dtype=float32"]
CLI_FLAGS = ["--biggan=True", "--hinge=True", "--resolution=16",
             "--filterG=8", "--filterD=8", "--z_size=8", "--batch_size=4",
             "--compute_dtype=float32", "--steps_per_log=1",
             "--data_loader_workers=1"]
LOSS_RTOL = 1e-5


def gen_params(run, out, **kw):
    return Namespace(**{**dict(model_log=run, num=8, batch=4, seed=0,
                               out=out, ncdhw=False, num_devices=2,
                               compute_dtype="", platform="cpu"), **kw})


def tourn_params(runs, data, **kw):
    return Namespace(**{**dict(batch_size=4, data_path=data, log_dir="log",
                               seed=0, n_seeds=1, num_devices=2,
                               compat_last_batch=False,
                               model_log=[runs["biggan"][:-1],
                                          runs["msl"][:-1]],
                               platform="cpu"), **kw})


def judge_input(r, seed=5):
    x = np.random.default_rng(seed).normal(size=(4, 1, r, r, r))
    return torch.from_numpy(np.tanh(x).astype(np.float32))


def scores(run, replicas):
    cfg, _, D = load_run(run, replicas=replicas)
    return make_discriminator_fn(cfg, D, replicas)(
        judge_input(cfg.resolution))


def cli_case(rp, data, log_dir, out_dir):
    """train_rank for 2 steps with track_energy, then a resume to 3, with
    this rank's stdout (``train{rank}.txt``), checkpoint writes and PNG
    writes recorded."""
    from gan3d_tpu_torch.cli import train as cli_train
    from gan3d_tpu_torch.config import config_from_args
    from gan3d_tpu_torch.train import checkpoint, trainer

    writes = {"ckpt": 0, "png": 0}
    save, grid = checkpoint.torch.save, trainer.save_volume_grid

    def counted_save(*a, **k):
        writes["ckpt"] += 1
        return save(*a, **k)

    def counted_grid(*a, **k):
        writes["png"] += 1
        return grid(*a, **k)

    checkpoint.torch.save = counted_save
    trainer.save_volume_grid = counted_grid
    argv = CLI_FLAGS + [f"--data_path={data}", f"--log_dir={log_dir}",
                        "--platform=cpu", "--num_devices=2",
                        "--track_energy=True"]
    try:
        with open(os.path.join(out_dir, f"train{rp.rank}.txt"), "w") as f, \
                contextlib.redirect_stdout(f):
            cli_train.train_rank(rp, config_from_args(argv + ["--niters=2"]))
            cli_train.train_rank(rp, config_from_args(argv + ["--niters=3"]))
    finally:
        checkpoint.torch.save, trainer.save_volume_grid = save, grid
    return writes


def eval_rank(rp, runs, data, out_dir):
    """The data-parallel side: generate each run, score a fixed batch with
    each run's D, and play the tournament, with this rank's stdout in
    ``stdout{rank}.txt``; then ``cli_case``. Every rank returns its
    results; rank 0's come back to the fixture, rank 1's in
    ``rank1.pt``."""
    torch.set_num_threads(1)
    with open(os.path.join(out_dir, f"stdout{rp.rank}.txt"), "w") as f, \
            contextlib.redirect_stdout(f):
        for fam in FAMILIES:
            generate.run(rp, gen_params(
                runs[fam], os.path.join(out_dir, f"{fam}_dp.npz")))
        judged = {fam: scores(runs[fam], rp) for fam in FAMILIES}
        means = tournament.run(rp, tourn_params(runs, data))
    out = {"scores": judged, "means": means,
           "cli": cli_case(rp, data, os.path.join(out_dir, "run"), out_dir)}
    if rp.rank:
        torch.save(out, os.path.join(out_dir, f"rank{rp.rank}.pt"))
    return out


def free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def dp_eval(tmp_path_factory):
    """Trains the two runs, then starts the two ranks and the two hosts;
    returns a function that waits for them: (rank 0's results, the
    runs, the hosts' (returncode, stdout), the output directory)."""
    from gan3d_tpu_torch.cli.train import main

    root = tmp_path_factory.mktemp("dp_eval")
    runs = {}
    for fam, (r, flags) in FAMILIES.items():
        data = str(root / f"test{r}.npz")
        if not os.path.isfile(data):
            np.savez(data, X=np.tanh(np.random.default_rng(0).normal(
                size=(8, r, r, r))).astype(np.float32))
        runs[fam], runs[f"data_{fam}"] = str(root / f"{fam}0"), data
        main([f"--data_path={data}", f"--log_dir={runs[fam]}",
              f"--resolution={r}", *TRAIN, *flags])
    out_dir = str(root)
    pool = ThreadPoolExecutor(max_workers=1)
    ranks_done = pool.submit(
        dist.launch, eval_rank, (runs, runs["data_biggan"], out_dir),
        dist.Plan(world=2, local=2, first=0, device="cpu"), JOIN_TIMEOUT)
    port = free_port()
    host_argv = [sys.executable, "-m", "gan3d_tpu_torch.cli.train",
                 f"--data_path={runs['data_biggan']}",
                 f"--log_dir={root / 'hosts'}", "--resolution=16", *TRAIN,
                 *FAMILIES["biggan"][1], "--steps_per_log=1",
                 "--distributed=True", "--num_processes=2", "--num_devices=2",
                 f"--coordinator_address=localhost:{port}"]
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    hosts = [subprocess.Popen(host_argv + [f"--process_id={i}"], cwd=REPO,
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for i in range(2)]
    state = {}

    def wait():
        if not state:
            state["r0"] = ranks_done.result()
            state["r1"] = torch.load(os.path.join(out_dir, "rank1.pt"),
                                     weights_only=False)
            state["hosts"] = []
            for h in hosts:
                out, _ = h.communicate(timeout=JOIN_TIMEOUT)
                state["hosts"].append((h.returncode, out))
        return state["r0"], runs, state["hosts"], out_dir, state["r1"]

    try:
        yield wait
    finally:
        for h in hosts:
            if h.poll() is None:
                h.kill()
                h.wait()
        pool.shutdown(wait=True)


@pytest.mark.parametrize("fam", list(FAMILIES))
def test_generate_at_two_ranks_matches_one_device(dp_eval, tmp_path, fam):
    r0, runs, _, out_dir, _ = dp_eval()
    one = str(tmp_path / "one.npz")
    generate.run(dist.ONE, gen_params(runs[fam], one, num_devices=1))
    want = np.load(one)["X"]
    got = np.load(os.path.join(out_dir, f"{fam}_dp.npz"))["X"]
    assert got.shape == want.shape == (8,) + (FAMILIES[fam][0],) * 3
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("fam", list(FAMILIES))
def test_judge_at_two_ranks_matches_one_device(dp_eval, fam):
    r0, runs, _, _, _ = dp_eval()
    want = scores(runs[fam], dist.ONE)
    torch.testing.assert_close(r0["scores"][fam], want, rtol=0, atol=1e-5)


def test_tournament_at_two_ranks_matches_one_device(dp_eval, capsys):
    r0, runs, _, out_dir, _ = dp_eval()
    want = tournament.run(dist.ONE, tourn_params(runs, runs["data_biggan"],
                                                 num_devices=1))
    printed = capsys.readouterr().out
    assert sorted(r0["means"]) == sorted(want)
    for k, v in want.items():
        assert 0.0 <= r0["means"][k] <= 1.0
        if r0["means"][k] != v:
            # a flip needs a fake scored at the bound, up to rounding
            pytest.fail(f"win rate {r0['means'][k]} != {v} for {k}")
    out0 = open(os.path.join(out_dir, "stdout0.txt")).read()
    out1 = open(os.path.join(out_dir, "stdout1.txt")).read()
    assert out0.count("------------- Tournament Results -------------") == 1
    assert re.findall(r"Win Rate of [0-9.]+", out0) == re.findall(
        r"Win Rate of [0-9.]+", printed)
    assert out1 == ""


def test_eval_clis_take_num_devices_zero(dp_eval, tmp_path, capsys):
    """``--num_devices=0`` on the CPU is one process (no process group)."""
    _, runs, _, _, _ = dp_eval()
    out = str(tmp_path / "z.npz")
    generate.main(["-l", runs["biggan"], "--num", "4", "--batch", "4",
                   "--out", out, "--platform=cpu", "--num_devices=0"])
    assert np.load(out)["X"].shape == (4, 16, 16, 16)
    assert not torch.distributed.is_initialized()
    assert not dist.plan(0, "cpu").parallel


def test_train_cli_across_two_hosts(dp_eval):
    _, _, hosts, out_dir, _ = dp_eval()
    (rc0, out0), (rc1, out1) = hosts
    assert rc0 == 0 and rc1 == 0, (out0[-2000:], out1[-2000:])
    assert "[1|2]\tD(x): " in out0 and "...Done (2 steps in " in out0
    assert "replica check: " in out0 and "on all 2 ranks" in out0
    assert "D(x)" not in out1 and "replica check" not in out1
    ckpt = torch.load(os.path.join(out_dir, "hosts", "models",
                                   "checkpoint.pt"), weights_only=True)
    assert ckpt["step"] == 2 and len(ckpt["lossG"]) == 2


def test_cli_train_and_resume_at_two_ranks(dp_eval, tmp_path):
    from gan3d_tpu_torch.cli.train import main

    r0, runs, _, out_dir, r1 = dp_eval()
    run = os.path.join(out_dir, "run")
    out0 = open(os.path.join(out_dir, "train0.txt")).read()
    out1 = open(os.path.join(out_dir, "train1.txt")).read()
    assert "[0|2]\tD(x): " in out0 and "starting from step 2" in out0
    assert "[2|3]\tD(x): " in out0 and "...Done (1 steps in " in out0
    # the trainer's replica check after each run
    assert out0.count("tensors bit-equal to rank 0's on all 2 ranks") == 2
    assert out1 == ""
    assert r0["cli"]["ckpt"] > 0 and r0["cli"]["png"] > 0
    assert r1["cli"] == {"ckpt": 0, "png": 0}
    for f in ("params.json", "models/checkpoint.pt", "images/2.png"):
        assert os.path.isfile(os.path.join(run, f)), f
    ckpt = torch.load(os.path.join(run, "models", "checkpoint.pt"),
                      weights_only=True)
    assert ckpt["step"] == 3 and len(ckpt["lossG"]) == 3
    # the one-process run's step 0
    one = str(tmp_path / "one")
    main(CLI_FLAGS + [f"--data_path={runs['data_biggan']}",
                      f"--log_dir={one}", "--platform=cpu",
                      "--num_devices=1", "--niters=1"])
    want = torch.load(os.path.join(one, "models", "checkpoint.pt"),
                      weights_only=True)
    np.testing.assert_allclose(ckpt["lossD"][0], want["lossD"][0],
                               rtol=LOSS_RTOL, atol=1e-7)
    np.testing.assert_allclose(ckpt["lossG"][0], want["lossG"][0],
                               rtol=LOSS_RTOL, atol=1e-7)


def test_energy_summary_matches_jax_keys(dp_eval):
    from gan3d_tpu.utils.energy import EnergyTracker as JEnergyTracker

    from gan3d_tpu_torch.utils.energy import CPU_WATTS

    _, _, _, out_dir, _ = dp_eval()
    with open(os.path.join(out_dir, "run", "energy.json")) as f:
        got = json.load(f)
    assert sorted(got) == sorted(JEnergyTracker(n_chips=2).summary())
    assert got["chips"] == 2
    assert got["watts_per_chip_estimate"] == CPU_WATTS
    assert got["active_seconds"] > 0 and got["kwh_estimate"] >= 0
