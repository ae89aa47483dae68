"""The metric registry, ported from
``inclusivegan_tpu/metrics/metric_defaults.py``: the same names and
arguments, with ``func_name`` in this package. Every metric is ported.
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


def metric_args(names) -> list:
    """The registry entries of ``names``; an unknown name raises ValueError,
    before anything loads."""
    out = []
    for name in names:
        if name not in metric_defaults:
            raise ValueError(f"unknown metric {name!r}; known: "
                             + ", ".join(metric_defaults))
        out.append(metric_defaults[name])
    check_metric_args(out)
    return out


def check_metric_args(metric_arg_list) -> None:
    """Build each metric of ``metric_arg_list`` without running it: a bad
    argument raises here, before anything loads."""
    from .metric_base import make_metric
    for args in metric_arg_list:
        make_metric(**dict(args))
