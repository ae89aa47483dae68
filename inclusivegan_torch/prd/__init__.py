"""PRD, precision and recall for distributions (Sajjadi et al. 2018), ported
from ``inclusivegan_tpu/prd``: the curves and F-beta pairs, the k-means
binning of embeddings on the data's device, a plot written without
matplotlib, and the folder command line (``prd_from_image_folders``)."""

from .prd_score import (  # noqa: F401
    compute_prd, compute_prd_from_embedding, prd_to_max_f_beta_pair, plot)
