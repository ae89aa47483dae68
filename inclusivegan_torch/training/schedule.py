"""Training schedule, copied from ``inclusivegan_tpu/training/schedule.py``.

Config-e/f never grows progressively (``lod_initial_resolution=None`` -> lod
0 always), so the LOD machinery reduces to the constant-resolution path; the
per-resolution minibatch and learning-rate dictionaries, the learning-rate
ramp and the tick cadence stay.
"""

from typing import Dict

import numpy as np

from ..utils.easydict import EasyDict


def training_schedule(cur_nimg: int, resolution_log2: int,
                      lod_initial_resolution=None,
                      lod_training_kimg: float = 600,
                      lod_transition_kimg: float = 600,
                      minibatch_size_base: int = 64,
                      minibatch_size_dict: Dict[int, int] = {},
                      minibatch_gpu_base: int = 32,
                      minibatch_gpu_dict: Dict[int, int] = {},
                      G_lrate_base: float = 0.002,
                      G_lrate_dict: Dict[int, float] = {},
                      D_lrate_base: float = 0.002,
                      D_lrate_dict: Dict[int, float] = {},
                      lrate_rampup_kimg: float = 0,
                      tick_kimg_base: float = 1,
                      tick_kimg_dict: Dict[int, float] = {}) -> EasyDict:
    s = EasyDict()
    s.kimg = cur_nimg / 1000.0

    phase_dur = lod_training_kimg + lod_transition_kimg
    phase_idx = int(np.floor(s.kimg / phase_dur)) if phase_dur > 0 else 0
    phase_kimg = s.kimg - phase_idx * phase_dur

    if lod_initial_resolution is None:
        s.lod = 0.0
    else:
        s.lod = float(resolution_log2)
        s.lod -= np.floor(np.log2(lod_initial_resolution))
        s.lod -= phase_idx
        if lod_transition_kimg > 0:
            s.lod -= max(phase_kimg - lod_training_kimg, 0.0) / lod_transition_kimg
        s.lod = max(s.lod, 0.0)
    s.resolution = 2 ** (resolution_log2 - int(np.floor(s.lod)))

    s.minibatch_size = minibatch_size_dict.get(s.resolution, minibatch_size_base)
    s.minibatch_gpu = minibatch_gpu_dict.get(s.resolution, minibatch_gpu_base)

    s.G_lrate = G_lrate_dict.get(s.resolution, G_lrate_base)
    s.D_lrate = D_lrate_dict.get(s.resolution, D_lrate_base)
    if lrate_rampup_kimg > 0:
        rampup = min(s.kimg / lrate_rampup_kimg, 1.0)
        s.G_lrate *= rampup
        s.D_lrate *= rampup

    s.tick_kimg = tick_kimg_dict.get(s.resolution, tick_kimg_base)
    return s


def resume_rampup_scale(kimg: float, resume_kimg: float,
                        rampup_kimg: float) -> float:
    """LR scale for warming Adam back up after a weights-only resume.

    The reference's ``lrate_rampup_kimg`` is anchored at kimg 0 and so does
    nothing for resumed runs; but resuming from a weights-only snapshot
    (``--resume-pkl``, reference run_training.py:210) restarts the Adam
    moments, and one full-lr step with zeroed second moments is effectively
    a huge step that knocks a converged GAN off its equilibrium (measured:
    962→874 modes within 20 kimg of such a resume). Linear 0→1 ramp over
    ``rampup_kimg`` past the resume point; 1.0 once past it or disabled."""
    if rampup_kimg <= 0:
        return 1.0
    return float(min(max(kimg - resume_kimg, 0.0) / rampup_kimg, 1.0))
