"""Run-dir harness, copied from ``inclusivegan_tpu/utils/run_harness.py``.

``submit_run`` makes a numbered run dir ``<run_dir_root>/NNNNN-<desc>``,
writes ``submit_config.pkl`` and ``submit_config.txt``, tees stdout and
stderr to ``log.txt``, resolves the run function from its dotted name and
calls it with the keyword arguments; a crash writes ``<task>-error.txt``, and
``_finished.txt`` marks the end either way. ``RunContext`` writes ``run.txt``
at start and stop and polls for an ``abort.txt`` in the run dir (a
cooperative stop). Runs are local processes: there is no other target.

With ``num_devices`` N over 1, the run dir is made once and N processes
(``spawn``) run the function as the ranks of a ``torch.distributed``
process group (``parallel.init_data_parallel``, initialized through a
file in the run dir): rank r on ``cuda:<r>`` for the ``device`` "cuda"
(NCCL), every rank on the named card for "cuda:K" (gloo), or the CPU
(gloo, the calling process's intra-op threads shared out), each with the
TF32 switches of the calling process. Rank 0 tees to
``log.txt``; the other ranks print nothing. The ranks' return values stay
in their processes: ``submit_run`` returns None.
"""

import datetime
import os
import pickle
import re
import time
import traceback
from typing import Any

from .easydict import EasyDict, pretty
from .logger import Logger
from .registry import get_obj_by_name


class SubmitConfig(EasyDict):
    """Config describing one run. Attribute names follow the reference
    (submit.py:64-101) so downstream code / run-dir artifacts line up."""

    def __init__(self, **kwargs):
        super().__init__()
        self.run_dir_root = "results"
        self.run_desc = ""
        self.run_func_name = None
        self.run_func_kwargs = {}
        self.num_devices = 1          # reference: num_gpus; ranks over 1
        self.print_info = False
        # populated by submit_run:
        self.run_id = None
        self.run_name = None
        self.run_dir = None
        self.submit_time = 0.0
        self.task_name = None
        self.host_name = "localhost"
        self.update(kwargs)


def _get_next_run_id(run_dir_root: str) -> int:
    ids = [0]
    if os.path.isdir(run_dir_root):
        for name in os.listdir(run_dir_root):
            m = re.match(r"^(\d+)-", name)
            if m:
                ids.append(int(m.group(1)) + 1)
    return max(ids)


def submit_run(submit_config: SubmitConfig, run_func_name: str, **run_func_kwargs) -> Any:
    """Create a run dir, install logging, resolve & call the run function."""
    submit_config = SubmitConfig(**submit_config)
    submit_config.run_func_name = run_func_name
    submit_config.run_func_kwargs = run_func_kwargs

    # --- run dir -----------------------------------------------------------
    os.makedirs(submit_config.run_dir_root, exist_ok=True)
    submit_config.run_id = _get_next_run_id(submit_config.run_dir_root)
    submit_config.run_name = f"{submit_config.run_id:05d}-{submit_config.run_desc}"
    run_dir = os.path.join(submit_config.run_dir_root, submit_config.run_name)
    assert not os.path.exists(run_dir), run_dir
    os.makedirs(run_dir)
    submit_config.run_dir = run_dir
    submit_config.submit_time = time.time()
    submit_config.task_name = f"{os.environ.get('USER', 'user')}-{submit_config.run_name}"

    with open(os.path.join(run_dir, "submit_config.pkl"), "wb") as f:
        pickle.dump(submit_config, f)
    with open(os.path.join(run_dir, "submit_config.txt"), "w") as f:
        f.write(pretty(submit_config) + "\n")

    world = int(submit_config.num_devices or 1)
    try:
        if world == 1:
            return _run_logged(submit_config, run_func_name, run_func_kwargs)
        import torch
        import torch.multiprocessing as mp
        init_file = os.path.join(run_dir, ".dist_init")
        tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
        # CPU ranks share out the caller's intra-op threads
        threads = max(1, torch.get_num_threads() // world)
        try:
            mp.start_processes(_run_rank, args=(world, submit_config, run_func_name,
                                                run_func_kwargs, init_file, tf32, threads),
                               nprocs=world, start_method="spawn")
        finally:
            if os.path.exists(init_file):
                os.remove(init_file)
        return None
    except Exception:
        with open(os.path.join(run_dir, f"{submit_config.task_name}-error.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        open(os.path.join(run_dir, "_finished.txt"), "w").close()


def _run_logged(submit_config, run_func_name, run_func_kwargs, ranks=""):
    """The run function, its output teed to ``log.txt``."""
    logger = Logger(os.path.join(submit_config.run_dir, "log.txt"), mode="w")
    start = time.time()
    try:
        print(f"dnnlib: Running {run_func_name}() on localhost{ranks}...")
        run_func = get_obj_by_name(run_func_name)
        result = run_func(submit_config=submit_config, **run_func_kwargs)
        print(f"dnnlib: Finished {run_func_name}() in "
              f"{datetime.timedelta(seconds=round(time.time() - start))}.")
        return result
    except Exception:
        traceback.print_exc()
        raise
    finally:
        logger.close()


def _run_rank(rank, world, submit_config, run_func_name, run_func_kwargs, init_file,
              tf32, threads):
    """One rank of a data-parallel run (a spawned process), with the TF32
    switches of the process that started it and, on the CPU, ``threads``
    intra-op threads."""
    import sys

    import torch
    import torch.distributed as dist

    from ..parallel import dist as pdist
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    device = run_func_kwargs.get("device", "cuda")
    dev = pdist.init_data_parallel(rank, world, "file://" + os.path.abspath(init_file),
                                   device=device)
    if dev.type == "cpu":
        torch.set_num_threads(threads)
    kwargs = dict(run_func_kwargs, device=dev)
    try:
        if rank == 0:
            _run_logged(submit_config, run_func_name, kwargs, f", {world} ranks")
        else:
            sys.stdout = open(os.devnull, "w")  # for the life of the process
            get_obj_by_name(run_func_name)(submit_config=submit_config, **kwargs)
    finally:
        dist.destroy_process_group()


class RunContext:
    """Loop helper: cooperative abort (``abort.txt``), run.txt metadata."""

    def __init__(self, submit_config: SubmitConfig):
        self.submit_config = submit_config
        self.should_stop_flag = False
        self.has_closed = False
        self.start_time = time.time()
        self.last_update_time = self.start_time
        self.last_update_interval = 0.0
        self._write_run_txt("start")

    def update(self, loss: Any = 0, cur_epoch: Any = 0, max_epoch: Any = None) -> None:
        assert not self.has_closed
        now = time.time()
        self.last_update_interval = now - self.last_update_time
        self.last_update_time = now

    def should_stop(self) -> bool:
        if not self.should_stop_flag:
            if os.path.exists(os.path.join(self.submit_config.run_dir, "abort.txt")):
                self.should_stop_flag = True
        return self.should_stop_flag

    def close(self) -> None:
        if not self.has_closed:
            self._write_run_txt("stop")
            self.has_closed = True

    def _write_run_txt(self, state: str) -> None:
        path = os.path.join(self.submit_config.run_dir, "run.txt")
        with open(path, "a") as f:
            f.write(f"{state}: {datetime.datetime.now().isoformat()} "
                    f"task {self.submit_config.task_name}\n")
