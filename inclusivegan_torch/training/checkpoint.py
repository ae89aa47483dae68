"""Full-state checkpoints, the port's counterpart of
``inclusivegan_tpu/training/checkpoint.py`` (orbax there).

A checkpoint holds what the JAX one holds: the step, G's, D's and Gs's
parameters and buffers, both Adam states (count, m, v), ``pl_mean``, and the
IMLE orchestrator's ``{"cursor", "staleness"}``. It is one ``torch.save``
file of plain tensors (on the CPU, in their dtypes) and numbers, no module,
at ``<ckpt_dir>/step_%08d/state.pt`` with the run's ``cur_nimg`` as the
step, so that the loop reads the resume kimg from the directory's name, and
read back with ``weights_only=True``. The snapshot pickle
(``snapshot.snapshot_dict``) stays the interchange format for the CLIs.

A save is atomic at the directory level, as orbax's: ``state.pt`` is
written into ``step_%08d.tmp<pid>``, a name that fails the ``step_<digits>``
test of ``latest_checkpoint`` and of the host tools
(``scripts/watchdog_mode_coverage.py``, ``scripts/mirror_best_checkpoint.py``),
and the directory is renamed to ``step_%08d`` only once the file is
complete, replacing an earlier save of the same step. A save that fails
leaves no directory behind; a process killed in the middle leaves only the
temporary one.
"""

import os
import shutil
from typing import Any, Dict, Optional, Tuple

import torch

from .optimizer import AdamState
from .train_state import TrainState, assign, params_of

STATE_FILE = "state.pt"


def _cpu(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().cpu() for k, v in tensors.items()}


def _opt(opt: AdamState) -> Dict[str, Any]:
    return {"count": opt.count.detach().cpu(), "m": _cpu(opt.m), "v": _cpu(opt.v)}


def save_checkpoint(ckpt_dir: str, state: TrainState,
                    imle_state: Optional[Dict[str, Any]] = None,
                    step: Optional[int] = None) -> str:
    """Write ``state`` (and the IMLE counters) under
    ``ckpt_dir/step_<step>``; ``step`` defaults to ``state.step``. Returns
    the checkpoint's directory."""
    step = int(state.step) if step is None else int(step)
    path = os.path.join(os.path.abspath(ckpt_dir), f"step_{step:08d}")
    payload = {
        "state": {
            "step": state.step.detach().cpu(),
            "g_params": _cpu(params_of(state.G)),
            "d_params": _cpu(params_of(state.D)),
            "gs_params": _cpu(params_of(state.Gs)),
            "g_opt": _opt(state.g_opt),
            "d_opt": _opt(state.d_opt),
            "pl_mean": state.pl_mean.detach().cpu(),
        },
        "imle": {k: int(v) for k, v in (imle_state or {}).items()},
    }
    tmp = f"{path}.tmp{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    try:
        torch.save(payload, os.path.join(tmp, STATE_FILE))
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    if os.path.isdir(path):  # an earlier save of this step: replaced whole
        old = f"{path}.old{os.getpid()}"
        os.rename(path, old)
        os.rename(tmp, path)
        shutil.rmtree(old)
    else:
        os.rename(tmp, path)
    return path


def load_checkpoint(path: str, target_state: TrainState
                    ) -> Tuple[TrainState, Dict[str, int]]:
    """Restore a checkpoint into ``target_state``'s networks (their
    parameters and buffers take the checkpoint's values and dtypes) on their
    device. Returns (state, imle dict)."""
    d = torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                   weights_only=True)
    s = d["state"]
    device = target_state.G.dlatent_avg.device

    def dev(tensors):
        return {k: v.to(device) for k, v in tensors.items()}

    def opt(o):
        return AdamState(o["count"].to(device), dev(o["m"]), dev(o["v"]))

    for module, key in ((target_state.G, "g_params"), (target_state.D, "d_params"),
                        (target_state.Gs, "gs_params")):
        live = params_of(module)
        if set(live) != set(s[key]):
            raise ValueError(f"{path}: {key} names differ from the networks': "
                             f"{sorted(set(live) ^ set(s[key]))[:5]}")
        assign(module, dev(s[key]))
    state = target_state._replace(step=s["step"].to(device), g_opt=opt(s["g_opt"]),
                                  d_opt=opt(s["d_opt"]), pl_mean=s["pl_mean"].to(device))
    return state, dict(d.get("imle", {}))


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """The ``step_<digits>`` directory of the highest step under
    ``ckpt_dir``; a save in progress (``step_<digits>.tmp<pid>``) is not
    one."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [d for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and d[len("step_"):].isdigit()]
    if not steps:
        return None
    return os.path.join(os.path.abspath(ckpt_dir),
                        max(steps, key=lambda d: int(d[len("step_"):])))
