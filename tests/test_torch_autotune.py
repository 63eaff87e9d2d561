"""``annonet_autotune`` of the port (annonet_tpu_torch/cli/autotune.py)
against tests/test_autotune.py's checks of the JAX tool: the search finds
the exact boundary against a fake probe and raises when nothing works;
--help does not probe; --coordinator is refused as in the JAX tool
(tests/test_multihost.py::test_autotune_refuses_coordinator), and --mesh
passes through to every probe. The probes key off annonet_train's
exit code, so a CUDA out-of-memory error must end annonet_train with a
nonzero code, in its setup (1) and in its loop (2), and the process must
exit. One real search on the CPU: the probes run under an address-space
limit on their data (RLIMIT_DATA), so a large enough batch fails to
allocate, as a batch too large for the card fails there; one more with
--mesh 2 on virtual shards.
"""

import os
import subprocess
import sys

import pytest

from annonet_tpu_torch.cli import autotune
from annonet_tpu_torch.cli.common import DEVICE_ENV
from tests.test_end_to_end import write_synthetic_dataset

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env():
    env = dict(os.environ)
    env[DEVICE_ENV] = "cpu"
    env["OMP_NUM_THREADS"] = "1"  # one allocation pattern on any machine
    env["PYTHONPATH"] = REPO_ROOT + os.pathsep + env.get("PYTHONPATH", "")
    return env


def searcher(max_working):
    """Simulate a device where sizes <= max_working pass."""
    calls = []

    def fake_probe(size, args):
        calls.append(size)
        return size <= max_working

    return fake_probe, calls


@pytest.mark.parametrize("start", [100, 8, 1000])
def test_search_finds_exact_boundary(monkeypatch, start):
    for boundary in [1, 7, 100, 137, 400, 1000]:
        fake_probe, calls = searcher(boundary)
        monkeypatch.setattr(autotune, "probe", fake_probe)
        found = autotune.find_max_minibatch_size([], start=start)
        assert found == boundary, (boundary, found, calls)


def test_search_raises_when_nothing_works(monkeypatch):
    fake_probe, _ = searcher(0)
    monkeypatch.setattr(autotune, "probe", fake_probe)
    with pytest.raises(RuntimeError, match="no minibatch size works"):
        autotune.find_max_minibatch_size([], start=100)


def test_autotune_help_does_not_probe(capsys, monkeypatch):
    monkeypatch.setattr(autotune, "probe", lambda *a: pytest.fail("probed"))
    assert autotune.main(["--help"]) == 0
    out = capsys.readouterr().out
    assert "annonet_autotune" in out and "probing" not in out
    assert "--minibatch-size" in out  # annonet_train's help follows
    assert autotune.main([]) == 1
    assert "probing" not in capsys.readouterr().out


@pytest.mark.parametrize("spelling", [["--coordinator", "127.0.0.1:1"],
                                      ["--coordinator=127.0.0.1:1"]])
def test_autotune_refuses_coordinator(capsys, monkeypatch, spelling):
    monkeypatch.setattr(autotune, "probe", lambda *a: pytest.fail("probed"))
    assert autotune.main(["/nonexistent", *spelling]) == 2
    assert "single-host" in capsys.readouterr().err


def test_autotune_with_mesh_end_to_end(tmp_path):
    """The counterpart of tests/test_autotune.py's mesh test: the probes
    and the real run all pass --mesh 2 through to annonet_train on virtual
    shards (ANNONET_TPU_VIRTUAL_MESH=1), under a data limit, so the search
    meets a boundary; the real run trains data-parallel."""
    write_synthetic_dataset(tmp_path, n_images=2, size=64)
    limit = 450 << 20
    launcher = (f"import os, resource, sys; resource.setrlimit(resource.RLIMIT_DATA, "
                f"({limit}, {limit})); sys.exit(__import__('annonet_tpu_torch.cli.autotune', "
                f"fromlist=['main']).main(sys.argv[1:]))")
    proc = subprocess.run(
        [sys.executable, "-c", launcher, "--start", "8", str(tmp_path), "--mesh", "2",
         "--level-count", "1", "--input-dimension-multiplier", "8",
         "--max-total-steps", "3", "--data-loader-thread-count", "1",
         "--output", str(tmp_path / "annonet.dnn"), "--sync-file", str(tmp_path / "sync.dat")],
        env={**_env(), "ANNONET_TPU_VIRTUAL_MESH": "1"}, capture_output=True, text=True,
        timeout=300, cwd=str(tmp_path),
    )
    assert proc.returncode == 0, proc.stdout[-1500:] + proc.stderr[-800:]
    probed = [int(line.split()[3].rstrip(".")) for line in proc.stdout.splitlines()
              if line.startswith("probing minibatch size")]
    best = int(proc.stdout.split("max working minibatch size: ")[1].split()[0])
    assert probed[0] == 8 and best in probed and best + 1 in probed
    assert f"launching the real run with -b {best}" in proc.stdout
    assert (tmp_path / "annonet.dnn").exists()


_OOM_RUN = """
import importlib, sys, torch
from annonet_tpu_torch.cli import train

def out_of_memory(*args, **kwargs):
    raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB")

setattr(getattr(importlib.import_module({module!r}), {cls!r}), {method!r}, out_of_memory)
sys.exit(train.main(sys.argv[1:]))
"""


@pytest.mark.parametrize("module, cls, method, extra, code", [
    # setup: the device image pool
    ("annonet_tpu_torch.train.device_cache", "DeviceImagePool", "__init__", [], 1),
    # the training loop, from the pool and from host crops
    ("annonet_tpu_torch.train.trainer", "Trainer", "train_step_decisions", [], 2),
    ("annonet_tpu_torch.train.trainer", "Trainer", "train_step_crops",
     ["--device-image-cache", "off"], 2),
])
def test_cuda_out_of_memory_ends_annonet_train_nonzero(tmp_path, module, cls, method, extra,
                                                       code):
    write_synthetic_dataset(tmp_path, n_images=2, size=32)
    script = _OOM_RUN.format(module=module, cls=cls, method=method)
    proc = subprocess.run(
        [sys.executable, "-c", script, str(tmp_path), "--max-total-steps", "3", "-b", "2",
         "--level-count", "0", "--data-loader-thread-count", "1",
         "--output", str(tmp_path / "m.dnn"), "--sync-file", str(tmp_path / "s.dat"), *extra],
        env=_env(), capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == code, proc.stdout + proc.stderr
    assert "CUDA out of memory" in proc.stdout
    assert not (tmp_path / "m.dnn").exists()


def test_autotune_end_to_end_on_the_cpu(tmp_path):
    """A real search: the probes are 3-step annonet_train runs whose data
    may not exceed 450 MiB (RLIMIT_DATA, inherited from the tool's
    process), so a large enough batch of crops fails to allocate."""
    write_synthetic_dataset(tmp_path, n_images=2, size=64)
    limit = 450 << 20
    launcher = (f"import os, resource, sys; resource.setrlimit(resource.RLIMIT_DATA, "
                f"({limit}, {limit})); sys.exit(__import__('annonet_tpu_torch.cli.autotune', "
                f"fromlist=['main']).main(sys.argv[1:]))")
    proc = subprocess.run(
        [sys.executable, "-c", launcher, "--start", "8", str(tmp_path),
         "--level-count", "1", "--input-dimension-multiplier", "8",
         "--max-total-steps", "3", "--data-loader-thread-count", "1",
         "--output", str(tmp_path / "annonet.dnn"), "--sync-file", str(tmp_path / "sync.dat")],
        env=_env(), capture_output=True, text=True, timeout=300, cwd=str(tmp_path),
    )
    assert proc.returncode == 0, proc.stdout[-1500:] + proc.stderr[-800:]
    probed = [int(line.split()[3].rstrip(".")) for line in proc.stdout.splitlines()
              if line.startswith("probing minibatch size")]
    best = int(proc.stdout.split("max working minibatch size: ")[1].split()[0])
    # the search met its boundary: it probed a size above the one it chose,
    # and the one above that one failed
    assert probed[0] == 8 and best in probed and best + 1 in probed
    assert f"launching the real run with -b {best}" in proc.stdout
    assert (tmp_path / "annonet.dnn").exists()
