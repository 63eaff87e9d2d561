"""Multi-process batch inference on the port (``annonet_infer
--coordinator``), the counterpart of tests/test_multihost_infer.py and of
tests/test_multihost.py's inference and classifier checks.

Each process infers the images i, i+P, ... of the directory's scan and
writes their result PNGs; one gloo all-gather at the end merges the
confusion matrices and timings, and process 0 alone prints them and
writes --report-json and the max-merged --save-calibration. The tests
start real subprocesses on the CPU (ANNONET_TPU_TORCH_DEVICE=cpu), each
with its own timeout, rendezvous on a free ephemeral port, and compare
with a single-process run of the same directory. A killed peer makes the
survivor exit with the peer-failure code 3 at once; a stopped one, within
ANNONET_TPU_HEARTBEAT_TIMEOUT.
"""

import inspect
import json
import os
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from annonet_tpu_torch import serialization
from annonet_tpu_torch.cli import common
from annonet_tpu_torch.cli.common import DEVICE_ENV
from annonet_tpu_torch.models.segnet import SegNetConfig, init_runtime_params
from annonet_tpu_torch.parallel import mesh as pmesh
from tests.test_end_to_end import write_synthetic_dataset
from tests.test_multihost_infer import _write_exposure_dataset

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 180  # seconds for any one subprocess


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(**extra) -> dict:
    env = dict(os.environ)
    env[DEVICE_ENV] = "cpu"
    env["OMP_NUM_THREADS"] = "2"
    env["PYTHONPATH"] = REPO_ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env["PYTHONUNBUFFERED"] = "1"
    env.update(extra)
    return env


def _write_model(path, classes_json):
    config = SegNetConfig(class_count=2, level_count=0, base_width=16)
    serialization.save_model(str(path), init_runtime_params(config, 3), config,
                             classes_json, 1.0)


def _infer_cmd(data_dir, model_path, report_path, extra=()):
    return [
        sys.executable, "-m", "annonet_tpu_torch.cli.infer", str(data_dir),
        "--model", str(model_path),
        "--tile-max-width", "64", "--tile-max-height", "64",
        "--full-image-reader-thread-count", "2",
        "--result-image-writer-thread-count", "2",
        "--report-json", str(report_path),
        *extra,
    ]


def _coordinated(rank, port, world=2):
    return ["--coordinator", f"127.0.0.1:{port}", "--num-processes", str(world),
            "--process-id", str(rank)]


def _run_ranks(cmds, env):
    """Run the ranks' commands together: (return codes, logs)."""
    procs = [subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for cmd in cmds]
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=TIMEOUT)
            logs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    return [p.returncode for p in procs], logs


@pytest.fixture(scope="module")
def shard_setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("mhinfer")
    data_single, data_multi = root / "data_single", root / "data_multi"
    for d in (data_single, data_multi):
        d.mkdir()
        # 5 images: an odd count, so the two shards are uneven (3 + 2)
        write_synthetic_dataset(d, n_images=5, size=48, seed=11)
    model = root / "annonet.dnn"
    _write_model(model, (data_single / "anno_classes.json").read_text())
    report_single = root / "report_single.json"
    single = subprocess.run(_infer_cmd(data_single, model, report_single), env=_env(),
                            capture_output=True, text=True, timeout=TIMEOUT)
    assert single.returncode == 0, single.stdout + single.stderr
    # the 2-process arm on an identical copy of the dataset, so that result
    # PNGs cannot leak between the arms
    port = _free_port()
    reports = [root / f"report_p{i}.json" for i in range(2)]
    rcs, logs = _run_ranks(
        [_infer_cmd(data_multi, model, reports[r], _coordinated(r, port)) for r in range(2)],
        _env())
    assert rcs == [0, 0], "\n===\n".join(logs)
    return {"data_single": data_single, "data_multi": data_multi,
            "report_single": report_single, "reports": reports, "logs": logs,
            "log_single": single.stdout}


def test_two_process_run_matches_single_process(shard_setup):
    single = json.loads(shard_setup["report_single"].read_text())
    merged = json.loads(shard_setup["reports"][0].read_text())
    assert merged["images"] == single["images"] == 5
    assert merged["processes"] == 2 and single["processes"] == 1
    for key in ("confusion_per_pixel", "confusion_per_region"):
        assert merged[key]["matrix"] == single[key]["matrix"], key
        assert merged[key]["accuracy"] == single[key]["accuracy"], key
    # per-image records cover only process 0's shard
    assert len(merged["per_image"]) == 3
    # the printed matrices too
    log0, single_log = shard_setup["logs"][0], shard_setup["log_single"]
    tail = "Confusion matrix per pixel"
    assert log0[log0.index(tail):].split("Report written")[0] == \
        single_log[single_log.index(tail):].split("Report written")[0]


def test_result_pngs_identical_across_arms(shard_setup):
    for i in range(5):
        a = shard_setup["data_single"] / f"img{i}.png_result.png"
        b = shard_setup["data_multi"] / f"img{i}.png_result.png"
        assert a.read_bytes() == b.read_bytes(), i


def test_rank_roles(shard_setup):
    log0, log1 = shard_setup["logs"]
    assert "Multi-host inference: process 0 of 2" in log0
    assert "Multi-host inference: process 1 of 2" in log1
    # only process 0 prints the merged totals and matrices and writes the report
    assert "Cluster totals: 5 images across 2 processes" in log0
    assert "Cluster totals" not in log1
    assert "Confusion matrix per pixel" in log0
    assert "Confusion matrix per pixel" not in log1
    assert not shard_setup["reports"][1].exists()
    assert "only process 0 writes --report-json" in log1
    assert "this process infers 3 (stride 2 from 0)" in log0
    assert "this process infers 2 (stride 2 from 1)" in log1


@pytest.fixture(scope="module")
def calibration_setup(tmp_path_factory):
    """4 images, alternating dark and bright, so the two stride shards
    {img0, img2} and {img1, img3} calibrate to different maxima. A
    single-process --save-calibration over each shard's directory is the
    ground truth; the merged file must be their element-wise max."""
    root = tmp_path_factory.mktemp("mhcalib")
    data = root / "data"
    data.mkdir()
    _write_exposure_dataset(data, [0.35, 1.0, 0.35, 1.0])
    shards = []
    for pid in range(2):
        d = root / f"shard{pid}"
        d.mkdir()
        (d / "anno_classes.json").write_text((data / "anno_classes.json").read_text())
        for i in range(pid, 4, 2):
            for suffix in (".png", ".png_mask.png"):
                (d / f"img{i}{suffix}").write_bytes((data / f"img{i}{suffix}").read_bytes())
        shards.append(d)
    model = root / "annonet.dnn"
    _write_model(model, (data / "anno_classes.json").read_text())
    calib = [root / f"calib_s{i}.npz" for i in range(2)] + [root / "calib_merged.npz"]
    int8 = ["--quantize", "int8", "--calibration-images", "2"]
    port = _free_port()
    cmds = [_infer_cmd(shards[pid], model, root / f"rs{pid}.json",
                       [*int8, "--save-calibration", str(calib[pid])]) for pid in range(2)]
    cmds += [_infer_cmd(data, model, root / f"rm{pid}.json",
                        [*int8, "--save-calibration", str(calib[2]), *_coordinated(pid, port)])
             for pid in range(2)]
    rcs, logs = _run_ranks(cmds, _env())
    assert rcs == [0, 0, 0, 0], "\n===\n".join(logs)
    return {"calib": calib, "logs": logs[2:], "model": model}


def test_merged_calibration_is_max_over_all_shards(calibration_setup):
    _, config, _, _ = serialization.load_model(str(calibration_setup["model"]))
    s0, s1, merged = (serialization.load_calibration(str(p), config)
                      for p in calibration_setup["calib"])
    assert len(merged) == len(s0) == len(s1)
    # the dark and bright shards calibrate differently somewhere, or this
    # test would prove nothing
    assert any(a.size and not np.array_equal(a, b) for a, b in zip(s0, s1))
    for a, b, m in zip(s0, s1, merged):
        np.testing.assert_array_equal(np.maximum(a, b), m)


def test_merged_calibration_rank_roles(calibration_setup):
    log0, log1 = calibration_setup["logs"]
    assert "maxima merged across 2 of 2 processes" in log0
    assert "Saved int8 calibration" in log0
    assert "Saved int8 calibration" not in log1


def test_mesh_does_not_compose_with_coordinator(tmp_path):
    write_synthetic_dataset(tmp_path, n_images=1, size=48, seed=0)
    model = tmp_path / "annonet.dnn"
    _write_model(model, (tmp_path / "anno_classes.json").read_text())
    proc = subprocess.run(
        _infer_cmd(tmp_path, model, tmp_path / "r.json",
                   ["--coordinator", "127.0.0.1:1", "--mesh", "2",
                    "--num-processes", "1", "--process-id", "0"]),
        env=_env(), capture_output=True, text=True, timeout=TIMEOUT)
    assert proc.returncode == 1
    assert "does not compose with --mesh" in proc.stdout


def _wait_for_line(path, needle, proc, timeout=TIMEOUT):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if needle in path.read_text(errors="replace"):
            return
        if proc.poll() is not None:
            raise AssertionError(f"exited early: {path.read_text(errors='replace')}")
        time.sleep(0.02)
    raise AssertionError(f"{needle!r} not seen in {path}")


@pytest.mark.parametrize("fault, bound", [
    # a killed peer severs its connections: the survivor's merge fails at once
    (signal.SIGKILL, 60.0),
    # a stopped peer is silent: the merge times out after the group's timeout
    (signal.SIGSTOP, 10.0 + 60.0),
], ids=["killed", "stopped"])
def test_rank_failure_mid_inference_is_bounded_and_diagnosed(tmp_path, fault, bound):
    """Rank 1 fails during the run: rank 0 must leave its merge with the
    peer-failure code and the diagnosis, within the bound, never hang."""
    data = tmp_path / "data"
    data.mkdir()
    # 400-px images: each rank's shard takes about a second, so the fault
    # lands before rank 1 reaches the merge
    write_synthetic_dataset(data, n_images=6, size=400, seed=5)
    model = tmp_path / "annonet.dnn"
    _write_model(model, (data / "anno_classes.json").read_text())
    port = _free_port()
    env = _env(ANNONET_TPU_HEARTBEAT_TIMEOUT="10")
    procs, logs = [], []
    for rank in range(2):
        logs.append(tmp_path / f"rank{rank}.log")
        with open(logs[-1], "w") as handle:
            procs.append(subprocess.Popen(
                _infer_cmd(data, model, tmp_path / f"r{rank}.json", _coordinated(rank, port)),
                env=env, stdout=handle, stderr=subprocess.STDOUT, text=True))
    try:
        _wait_for_line(logs[1], "Multi-host inference: process 1", procs[1])
        procs[1].send_signal(fault)
        t_fault = time.monotonic()
        procs[0].wait(timeout=bound)
        elapsed = time.monotonic() - t_fault
        log0 = logs[0].read_text(errors="replace")
        assert procs[0].returncode == common.PEER_FAILURE_EXIT_CODE, (elapsed, log0)
        assert "multi-host peer failure detected" in log0, log0
        assert elapsed < bound
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)


def test_peer_failure_classifier_measured_phrases_only():
    """The classifier accepts gloo's measured peer-failure texts and nothing
    broader: a rank-local error that merely contains a transport word must
    take the rank-local path (tests/test_multihost.py's rule)."""
    classified = [
        # measured: the peer killed before or during the collective
        "[/__w/pytorch/pytorch/third_party/gloo/gloo/transport/tcp/pair.cc:553] "
        "Connection closed by peer [127.0.0.1]:17287. This is typically caused by "
        "a remote worker crashing.",
        # measured: the peer stopped, the group's timeout expired
        "[/__w/pytorch/pytorch/third_party/gloo/gloo/transport/tcp/unbound_buffer.cc:129] "
        "Timed out waiting 5000ms for send operation to complete",
        "[/__w/pytorch/pytorch/third_party/gloo/gloo/transport/tcp/unbound_buffer.cc:78] "
        "Timed out waiting 5000ms for recv operation to complete",
        "Application timeout caused pair closure",
    ]
    for text in classified:
        assert common.peer_failure_diagnosis(RuntimeError(text)) is not None, text
    rank_local = [
        "OSError: [Errno 104] Connection reset by peer: '/mnt/nfs/data/img_0001.png'",
        "ConnectionRefusedError: [Errno 111] Connection refused",
        "DEADLINE_EXCEEDED: rpc to storage backend timed out",
        "training diverged: loss is nan at step 7",
        "device probe failed: something",
        # measured: a wrong coordinator address, and a peer that never started
        "The client socket has timed out after 4000ms while trying to connect to "
        "(127.0.0.1, 39763).",
        "Timed out after 5 seconds waiting for clients. 1/2 clients joined.",
    ]
    for text in rank_local:
        assert common.peer_failure_diagnosis(RuntimeError(text)) is None, text


def test_peer_failure_exit_code_is_one_value(capsys):
    """One exit code for every classified peer failure: the handler takes
    no other, and nothing exits for an unclassified error or a single
    process."""
    assert common.PEER_FAILURE_EXIT_CODE == 3
    assert list(inspect.signature(common.exit_on_peer_failure).parameters) == [
        "exc", "multihost"]
    from annonet_tpu_torch.cli import infer

    assert "exit_on_peer_failure(e, bool(args.coordinator))" in inspect.getsource(infer.main)
    common.exit_on_peer_failure(RuntimeError("Connection closed by peer"), False)
    common.exit_on_peer_failure(RuntimeError("loss is nan"), True)
    assert capsys.readouterr().out == ""


def test_initialize_distributed_arguments(monkeypatch):
    with pytest.raises(ValueError, match="requires --num-processes and --process-id"):
        pmesh.initialize_distributed("127.0.0.1:1", num_processes=2)
    monkeypatch.setenv("ANNONET_TPU_HEARTBEAT_TIMEOUT", "soon")
    with pytest.raises(ValueError, match="not an integer number of seconds"):
        pmesh.initialize_distributed("127.0.0.1:1", 1, 0)
    monkeypatch.setenv("ANNONET_TPU_HEARTBEAT_TIMEOUT", "0")
    with pytest.raises(ValueError, match="must be a positive integer"):
        pmesh.initialize_distributed("127.0.0.1:1", 1, 0)
    assert not torch.distributed.is_initialized()
