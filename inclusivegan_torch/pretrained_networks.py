"""Pretrained networks by alias, the port's counterpart of the repository's
``pretrained_networks.py``: the same alias map and a cached loader, reading
``network_snapshot.v1`` pickles through ``snapshot.load_networks``.

    from inclusivegan_torch import pretrained_networks
    G, D, Gs = pretrained_networks.load_networks("artifacts/celeba_best_weights_fp16.pkl")
"""

import os
from typing import Dict, Tuple

from .snapshot import load_networks as _load_snapshot_networks

gdrive_urls = {
    # the original project's aliases; each names a converted snapshot under
    # models/, which the port does not download
    "gdrive:stacked-mnist-240k.pkl": "models/stacked-mnist-240k.pkl",
    "gdrive:celeba-30k.pkl": "models/celeba-30k.pkl",
    "gdrive:celeba-30k-eyeglasses.pkl": "models/celeba-30k-eyeglasses.pkl",
}

_cached_networks: Dict[Tuple[str, str], Tuple] = {}


def get_path_or_url(path_or_gdrive_path: str) -> str:
    return gdrive_urls.get(path_or_gdrive_path, path_or_gdrive_path)


def load_networks(path_or_gdrive_path: str, device="cuda") -> Tuple:
    """(G, D, Gs) of a snapshot, by path or alias, on ``device``; a second
    call with the same path and device returns the same objects."""
    path = get_path_or_url(path_or_gdrive_path)
    key = (path, str(device))
    if key in _cached_networks:
        return _cached_networks[key]
    if not os.path.isfile(path):
        raise FileNotFoundError(
            f"{path} not found: point the alias at an "
            "inclusivegan_tpu.network_snapshot.v1 pickle")
    nets = _load_snapshot_networks(path, device)
    _cached_networks[key] = nets
    return nets
