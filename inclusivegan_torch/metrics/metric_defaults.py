"""The metric registry, ported from
``inclusivegan_tpu/metrics/metric_defaults.py``: the same names and
arguments, with ``func_name`` in this package.

FID (``fid30k``, ``fid10k``), IS (``is50k``) and ``dummy`` are ported. The
others keep their entries, so that a name means the same in both packages,
and ``check_ported`` refuses them with the ``ROADMAP.md`` item that brings
each, before anything loads.
"""

from ..utils.easydict import EasyDict

_P = "inclusivegan_torch.metrics"

metric_defaults = {m.name: m for m in [
    EasyDict(name="mode_counts_24k",
             func_name=f"{_P}.mode_counts.ModeCounts",
             num_images=24576, minibatch_per_gpu=32),
    EasyDict(name="KL24k", func_name=f"{_P}.KL.KL",
             num_images=24576, minibatch_per_gpu=32),
    EasyDict(name="fid30k",
             func_name=f"{_P}.frechet_inception_distance.FID",
             num_images=30000, minibatch_per_gpu=8),
    EasyDict(name="fid10k",
             func_name=f"{_P}.frechet_inception_distance.FID",
             num_images=10000, minibatch_per_gpu=8),
    EasyDict(name="is50k", func_name=f"{_P}.inception_score.IS",
             num_images=50000, num_splits=10, minibatch_per_gpu=8),
    EasyDict(name="ppl_zfull", func_name=f"{_P}.perceptual_path_length.PPL",
             num_samples=50000, epsilon=1e-4, space="z", sampling="full",
             crop=True, minibatch_per_gpu=16),
    EasyDict(name="ppl_wfull", func_name=f"{_P}.perceptual_path_length.PPL",
             num_samples=50000, epsilon=1e-4, space="w", sampling="full",
             crop=True, minibatch_per_gpu=16),
    EasyDict(name="ppl_zend", func_name=f"{_P}.perceptual_path_length.PPL",
             num_samples=50000, epsilon=1e-4, space="z", sampling="end",
             crop=True, minibatch_per_gpu=16),
    EasyDict(name="ppl_wend", func_name=f"{_P}.perceptual_path_length.PPL",
             num_samples=50000, epsilon=1e-4, space="w", sampling="end",
             crop=True, minibatch_per_gpu=16),
    EasyDict(name="ppl2_wend", func_name=f"{_P}.perceptual_path_length.PPL",
             num_samples=50000, epsilon=1e-4, space="w", sampling="end",
             crop=False, minibatch_per_gpu=16),
    EasyDict(name="ls", func_name=f"{_P}.linear_separability.LS",
             num_samples=200000, num_keep=100000, attrib_indices=range(40),
             minibatch_per_gpu=4),
    EasyDict(name="pr50k3", func_name=f"{_P}.precision_recall.PR",
             num_images=50000, nhood_size=3, minibatch_per_gpu=8,
             row_batch_size=10000, col_batch_size=10000),
    EasyDict(name="dummy", func_name=f"{_P}.metric_base.DummyMetric"),
]}

# The metric classes not ported yet, by func_name, and what brings each.
_NOT_PORTED = {
    f"{_P}.precision_recall.PR": "precision_recall.py (ROADMAP.md, queue 1 item 3.1)",
    f"{_P}.perceptual_path_length.PPL":
        "perceptual_path_length.py on the ported LPIPS (ROADMAP.md, queue 1 item 3.2)",
    f"{_P}.linear_separability.LS": "linear_separability.py with the CelebA "
                                    "attribute classifier (ROADMAP.md, queue 1 item 3.3)",
    f"{_P}.mode_counts.ModeCounts": "mode_counts.py with models/feature_nets.py "
                                    "(ROADMAP.md, queue 1 item 3.5)",
    f"{_P}.KL.KL": "KL.py with models/feature_nets.py (ROADMAP.md, queue 1 item 3.5)",
}


def check_ported(name: str, func_name: str) -> None:
    """Raise NotImplementedError if the metric's class is not ported yet."""
    why = _NOT_PORTED.get(func_name)
    if why is not None:
        raise NotImplementedError(f"metric {name} is not ported yet: {why}")


def metric_args(names) -> list:
    """The registry entries of ``names``; an unknown name raises ValueError,
    one not ported yet NotImplementedError."""
    out = []
    for name in names:
        if name not in metric_defaults:
            raise ValueError(f"unknown metric {name!r}; known: "
                             + ", ".join(metric_defaults))
        out.append(metric_defaults[name])
    check_metric_args(out)
    return out


def check_metric_args(metric_arg_list) -> None:
    """Build each metric of ``metric_arg_list`` without running it: a
    metric, or an option of one, that is not ported yet raises
    NotImplementedError here, before anything loads."""
    from .metric_base import make_metric
    for args in metric_arg_list:
        make_metric(**dict(args))
