"""Two OS processes of the port's ``scripts/multihost_worker.py`` (``python
-m inclusivegan_torch.scripts.multihost_worker``) join one gloo process
group over ``tcp://`` on the CPU and take one training step of the port's
``train_step``, each on its slice of the global batch: both hold the same
bytes after it (parameters, Adam moments, EMA, ``pl_mean``), the same loss
scalars, and the same as the two ranks that ``submit_run`` spawns for the
same step (``SubmitConfig.num_devices``, initialized through a file), as
the JAX package's ``tests/test_multihost.py`` holds its two processes."""

import json
import os
import socket
import subprocess
import sys

from inclusivegan_torch.utils.run_harness import SubmitConfig, submit_run

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_processes_and_the_spawned_ranks_hold_the_same_state(tmp_path):
    port = _free_port()
    outs = [tmp_path / f"process{i}.json" for i in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "inclusivegan_torch.scripts.multihost_worker",
         "--process-id", str(i), "--num-processes", "2", "--coordinator",
         f"127.0.0.1:{port}", "--out", str(outs[i]), "--device", "cpu"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(2)]
    logs = [p.communicate(timeout=600)[0] for p in procs]
    for i, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"process {i} failed:\n{log[-4000:]}"
    processes = [json.loads(out.read_text()) for out in outs]

    spawned_dir = tmp_path / "spawned"
    spawned_dir.mkdir()
    submit_run(SubmitConfig(run_dir_root=str(tmp_path / "results"), run_desc="multihost",
                            num_devices=2),
               "inclusivegan_torch.scripts.multihost_worker.run_step",
               out_dir=str(spawned_dir), device="cpu")
    spawned = [json.loads((spawned_dir / f"worker{i}.json").read_text()) for i in range(2)]

    for i, r in enumerate(processes + spawned):
        assert (r["process_id"], r["process_count"]) == (i % 2, 2)
    digests = {r["params_sha256"] for r in processes + spawned}
    assert len(digests) == 1, digests
    assert all(r["scalars"] == processes[0]["scalars"] for r in processes + spawned)
    assert len(processes[0]["scalars"]) > 5
