"""Multi-process data-parallel training on the port: ``annonet_train
--coordinator`` over a gloo group, the counterpart of
tests/test_multihost.py.

Real subprocesses on free local ports, each under a timeout, on the CPU:
every process runs the same command on the same dataset with the same seed
(--deterministic-data is forced), each with 2 virtual shards
(ANNONET_TPU_VIRTUAL_MESH=1, --mesh 4 over 2 processes). The port sums
every cross-shard term in global shard order on every process, so
2 processes x 2 shards equal 1 process x 4 shards; the artifacts are held
at JAX's rtol 2e-5, atol 1e-6. Rank 0 alone writes files; ranks resume
from one shared sync file, and a mismatch fails them all; a killed rank
or coordinator ends the survivor with PEER_FAILURE_EXIT_CODE within the
heartbeat; --int8-training composes (one activation scale over the
processes) and rank 0 alone validates.
"""

import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

from annonet_tpu_torch import serialization
from annonet_tpu_torch.cli import common
from annonet_tpu_torch.models.segnet import tree_items
from tests.test_end_to_end import write_synthetic_dataset
from tests.test_torch_multihost_infer import _env, _free_port, _run_ranks, _wait_for_line

TIMEOUT = 180  # seconds for any one subprocess


def _train_cmd(data, out, sync, steps=6, extra=()):
    return [
        sys.executable, "-m", "annonet_tpu_torch.cli.train", str(data),
        "--max-total-steps", str(steps), "-b", "8", "--mesh", "4",
        "--level-count", "0", "--net-width-scaler", "0.5",
        "--input-dimension-multiplier", "1.0", "--initial-learning-rate", "0.02",
        "--data-loader-thread-count", "2", "--deterministic-data",
        "--loss-sync-interval", "2", "--seed", "0", "--save-interval", "1000",
        "--output", str(out), "--sync-file", str(sync), *extra,
    ]


def _env_mesh(**extra):
    return _env(ANNONET_TPU_VIRTUAL_MESH="1", **extra)


def _pair(data, outs, syncs, steps=6, extra=(), env=None):
    port = _free_port()
    return _run_ranks([
        _train_cmd(data, outs[r], syncs[r], steps, [
            *extra, "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
            "--process-id", str(r)])
        for r in range(2)], env or _env_mesh())


def _single(data, out, sync, steps=6, extra=()):
    r = subprocess.run(_train_cmd(data, out, sync, steps, extra), env=_env_mesh(),
                       capture_output=True, text=True, timeout=TIMEOUT)
    assert r.returncode == 0, r.stdout + r.stderr
    return r.stdout


def _assert_artifacts_close(a, b):
    pa, ca, ja, fa = serialization.load_model(str(a))
    pb, cb, jb, fb = serialization.load_model(str(b))
    assert ca == cb and ja == jb and fa == fb
    la, lb = dict(tree_items(pa)), dict(tree_items(pb))
    assert la.keys() == lb.keys()
    for k in la:
        np.testing.assert_allclose(la[k], lb[k], rtol=2e-5, atol=1e-6,
                                   err_msg=f"artifacts diverged at {k}")


@pytest.fixture
def data(tmp_path):
    d = tmp_path / "data"
    d.mkdir()
    write_synthetic_dataset(d, n_images=3, size=40)
    return d


def test_two_processes_match_one_process(data, tmp_path):
    """2 processes x 2 shards == 1 process x 4 shards; rank 0 alone writes
    the artifact, the sync file and the metrics."""
    single = tmp_path / "single.dnn"
    _single(data, single, tmp_path / "single.dat")
    outs = [tmp_path / "mh0.dnn", tmp_path / "mh1.dnn"]
    syncs = [tmp_path / "mh0.dat", tmp_path / "mh1.dat"]
    metrics = [tmp_path / "m0.jsonl", tmp_path / "m1.jsonl"]
    port = _free_port()
    rcs, logs = _run_ranks([
        _train_cmd(data, outs[r], syncs[r], extra=[
            "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
            "--process-id", str(r), "--metrics-jsonl", str(metrics[r])])
        for r in range(2)], _env_mesh())
    assert rcs == [0, 0], logs
    assert "Multi-host training: process 1 of 2" in logs[1]
    assert "forcing --deterministic-data" not in logs[0]  # it was asked for
    assert all(p.exists() for p in (outs[0], syncs[0], metrics[0]))
    assert not any(p.exists() for p in (outs[1], syncs[1], metrics[1]))
    _assert_artifacts_close(single, outs[0])


def test_resume_through_a_shared_sync_file(data, tmp_path):
    """Both ranks stop and resume from one sync file: the continued run
    matches a single-process run with the same stop and resume."""
    single, single_sync = tmp_path / "single.dnn", tmp_path / "single.dat"
    for steps in (3, 6):
        _single(data, single, single_sync, steps)
    outs = [tmp_path / "mh0.dnn", tmp_path / "mh1.dnn"]
    shared = tmp_path / "shared.dat"
    rcs, logs = _pair(data, outs, [shared, shared], steps=3)
    assert rcs == [0, 0], logs
    rcs, logs = _pair(data, outs, [shared, shared], steps=6)
    assert rcs == [0, 0], logs
    for log in logs:
        assert "resumed from" in log and "at step 3" in log, log
    _assert_artifacts_close(single, outs[0])


def test_resume_mismatch_fails_every_rank(data, tmp_path):
    """Per-rank sync paths leave rank 1 without the checkpoint rank 0
    wrote: the restart fails the resume check on both ranks (exit 1)."""
    outs = [tmp_path / "mh0.dnn", tmp_path / "mh1.dnn"]
    syncs = [tmp_path / "mh0.dat", tmp_path / "mh1.dat"]
    rcs, logs = _pair(data, outs, syncs, steps=2)
    assert rcs == [0, 0], logs
    assert syncs[0].exists() and not syncs[1].exists()
    rcs, logs = _pair(data, outs, syncs, steps=4)
    assert rcs == [1, 1], logs
    for log in logs:
        assert "multi-host resume mismatch" in log, log


def test_coordinator_requires_mesh(tmp_path, capsys, monkeypatch):
    from annonet_tpu_torch.cli import train

    monkeypatch.setenv(common.DEVICE_ENV, "cpu")
    (tmp_path / "anno_classes.json").write_text("")
    assert train.main([str(tmp_path), "--coordinator", "127.0.0.1:1"]) == 1
    assert "--coordinator requires --mesh" in capsys.readouterr().out


def test_mesh_must_cover_the_global_devices(data, tmp_path):
    """--mesh 3 over 2 processes of max(1, 3 // 2) virtual shards: the
    global mesh is 2 shards, not 3, and both ranks refuse at setup."""
    outs = [tmp_path / "mh0.dnn", tmp_path / "mh1.dnn"]
    port = _free_port()
    cmds = [_train_cmd(data, outs[r], tmp_path / f"s{r}.dat", 2, [
        "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
        "--process-id", str(r)]) for r in range(2)]
    cmds = [[a if a != "4" or c[i - 1] != "--mesh" else "3" for i, a in enumerate(c)]
            for c in cmds]
    rcs, logs = _run_ranks(cmds, _env_mesh())
    assert rcs == [1, 1], logs
    for log in logs:
        assert "must equal the global device count (2" in log, log


def test_local_virtual_devices_is_jaxs():
    from annonet_tpu_torch.parallel.mesh import local_virtual_devices

    assert [local_virtual_devices(n, 2) for n in (1, 2, 3, 4, 8)] == [1, 1, 1, 2, 4]


@pytest.mark.parametrize("victim", [1, 0], ids=["rank", "coordinator"])
def test_a_dead_peer_ends_the_survivor_within_the_heartbeat(data, tmp_path, victim):
    """Kill one rank mid-training: the other leaves with the peer-failure
    code and its diagnosis, within the heartbeat (never a hang)."""
    port = _free_port()
    env = _env_mesh(ANNONET_TPU_HEARTBEAT_TIMEOUT="10")
    procs, logs = [], []
    for r in range(2):
        logs.append(tmp_path / f"rank{r}.log")
        with open(logs[-1], "w") as handle:
            procs.append(subprocess.Popen(
                _train_cmd(data, tmp_path / f"m{r}.dnn", tmp_path / "shared.dat", 100000, [
                    "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
                    "--process-id", str(r)]),
                env=env, stdout=handle, stderr=subprocess.STDOUT, text=True))
    survivor = 1 - victim
    try:
        _wait_for_line(logs[survivor], "Now training", procs[survivor])
        time.sleep(2)  # steps and their collectives in flight
        procs[victim].send_signal(signal.SIGKILL)
        t_kill = time.monotonic()
        procs[survivor].wait(timeout=10 + 60)
        elapsed = time.monotonic() - t_kill
        log = logs[survivor].read_text(errors="replace")
        assert procs[survivor].returncode == common.PEER_FAILURE_EXIT_CODE, (elapsed, log[-3000:])
        assert "multi-host peer failure detected" in log, log
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)


def test_int8_training_and_validation_across_processes(data, tmp_path):
    """--int8-training's activation scale is the maximum over every
    process's shards, so the pair matches one process; rank 0 alone runs
    --validation-directory."""
    single = tmp_path / "single.dnn"
    _single(data, single, tmp_path / "single.dat", extra=["--int8-training"])
    outs = [tmp_path / "mh0.dnn", tmp_path / "mh1.dnn"]
    rcs, logs = _pair(data, outs, [tmp_path / "mh0.dat", tmp_path / "mh1.dat"],
                      extra=["--int8-training", "--validation-directory", str(data)])
    assert rcs == [0, 0], logs
    assert "validation (step" in logs[0]
    assert "validation (step" not in logs[1]
    _assert_artifacts_close(single, outs[0])


def test_rank_device_and_argument_errors(tmp_path, monkeypatch):
    """--coordinator host:port without the process count and id is a setup
    error, as in the inference CLI."""
    from annonet_tpu_torch.cli import train

    monkeypatch.setenv(common.DEVICE_ENV, "cpu")
    write_synthetic_dataset(tmp_path, n_images=1, size=16)
    assert train.main([str(tmp_path), "--mesh", "2", "--coordinator", "127.0.0.1:1"]) == 1


def test_main_exits_with_the_peer_code_on_a_setup_collective(monkeypatch, capsys):
    """A dead peer raised from a setup collective (the resume check) leaves
    with PEER_FAILURE_EXIT_CODE, not the setup code."""
    from annonet_tpu_torch.cli import train

    def dead_peer(*a, **k):
        raise RuntimeError("[pair.cc:553] Connection closed by peer [127.0.0.1]:1")

    monkeypatch.setattr(train, "_run", dead_peer)
    exits = []
    monkeypatch.setattr(os, "_exit", lambda code: exits.append(code) or (_ for _ in ()).throw(
        SystemExit(code)))
    with pytest.raises(SystemExit):
        train.main(["/nonexistent", "--mesh", "2", "--coordinator", "127.0.0.1:1"])
    assert exits == [common.PEER_FAILURE_EXIT_CODE]
    assert "multi-host peer failure detected" in capsys.readouterr().out


def test_the_training_read_error_is_a_peer_failure():
    """gloo's text when a peer dies under a training collective (measured:
    a rank SIGKILLed mid-training) is classified; a rank-local reset that
    merely names the transport is not."""
    measured = ("[/__w/pytorch/pytorch/third_party/gloo/gloo/transport/tcp/pair.cc:537] "
                "Read error [127.0.0.1]:5850: Connection reset by peer. This is typically "
                "caused by a remote worker hanging or bugs in the application.")
    assert common.peer_failure_diagnosis(RuntimeError(measured)) is not None
    assert common.peer_failure_diagnosis(RuntimeError(
        "OSError: [Errno 104] Connection reset by peer: '/mnt/nfs/img.png'")) is None


def test_resume_state_vector_is_jaxs(tmp_path):
    """The resume check's per-rank vector equals the JAX CLI's on the same
    files: a written sync file, a missing one and an unreadable one."""
    from annonet_tpu.cli.train import _resume_state_vector as jax_vector
    from annonet_tpu_torch.cli.train import _resume_state_vector
    from annonet_tpu_torch.models.segnet import SegNetConfig
    from annonet_tpu_torch.train import Trainer, TrainerConfig

    written = tmp_path / "a.dat"
    Trainer(SegNetConfig(class_count=2, level_count=0, base_width=4),
            TrainerConfig(sync_file=str(written)), seed=0, device="cpu").save_sync_file()
    (tmp_path / "junk.dat").write_bytes(b"not-an-npz")
    for path in (written, tmp_path / "missing.dat", tmp_path / "junk.dat"):
        assert np.array_equal(_resume_state_vector(str(path)), jax_vector(str(path))), path
    assert _resume_state_vector(str(written))[:8].view(np.int64)[0] == 0
