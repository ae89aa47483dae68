"""Read ``inclusivegan_tpu.network_snapshot.v1`` pickles and carry the JAX
package's numpy parameter trees across to the port's ``GMain`` and
``Discriminator``, and the whole (G, D, Gs) triple as a training state.

A snapshot is a pickle of plain dicts and numpy arrays:
``{"format", "G", "D", "Gs"}`` with ``{"config", "params"}`` per network (the
fp16 mirrors add ``mirror_meta``). As the JAX package's ``load_snapshot``
does, the stored compute ``dtype`` is dropped, so the model runs in float32;
parameters keep their stored dtype.
"""

import pickle
from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

from .models.stylegan2 import Discriminator, GMain, GMapping, GSynthesis

SNAPSHOT_FORMAT = "inclusivegan_tpu.network_snapshot"


class _Unpickler(pickle.Unpickler):
    """Snapshots written under numpy >= 2 name ``numpy._core``; under an
    older numpy that module is ``numpy.core``."""

    def find_class(self, module, name):
        if (module.split(".")[0:2] == ["numpy", "_core"]
                and int(np.__version__.split(".")[0]) < 2):
            module = "numpy.core" + module[len("numpy._core"):]
        return super().find_class(module, name)


def read_snapshot(path: str) -> Dict[str, Any]:
    """The raw snapshot dict. Unpickle only snapshots this project wrote."""
    with open(path, "rb") as f:
        snap = _Unpickler(f).load()
    if not str(snap.get("format", "")).startswith(SNAPSHOT_FORMAT):
        raise ValueError(f"{path}: not a {SNAPSHOT_FORMAT} pickle")
    return snap


def _flatten(tree: Dict[str, Any], prefix: str = "") -> Iterator[Tuple[str, np.ndarray]]:
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flatten(value, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", np.asarray(value)


def params_to_state_dict(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A JAX G or D parameter tree as the port's state dict: keys joined
    with ".", conv weights [k, k, I, O] transposed to OIHW, dtypes kept."""
    state = {}
    for key, arr in _flatten(params):
        t = torch.from_numpy(np.array(arr))
        if key.endswith("weight") and t.ndim == 4:
            t = t.permute(3, 2, 0, 1).contiguous()
        state[key] = t
    return state


def gmain_from_params(config: Dict[str, Any], params: Dict[str, Any],
                      device="cuda") -> GMain:
    """Build the port's ``GMain`` from a JAX ``GMain`` config dict (the
    snapshot's ``Gs.config``) and its numpy parameter tree."""
    cfg = dict(config)
    mapping_cfg = dict(cfg.pop("mapping"))
    synthesis_cfg = dict(cfg.pop("synthesis"))
    for c in (mapping_cfg, synthesis_cfg):
        c.pop("dtype", None)  # the stored compute dtype; the port runs float32
    G = GMain(GMapping(**mapping_cfg), GSynthesis(**synthesis_cfg), **cfg)
    G.load_state_dict(params_to_state_dict(params), strict=True, assign=True)
    return G.to(device)


def discriminator_from_params(config: Dict[str, Any], params: Dict[str, Any],
                              device="cuda") -> Discriminator:
    """Build the port's ``Discriminator`` from a JAX ``Discriminator`` config
    dict (the snapshot's ``D.config``) and its numpy parameter tree."""
    cfg = dict(config)
    cfg.pop("dtype", None)  # the stored compute dtype; the port runs float32
    D = Discriminator(**cfg)
    D.load_state_dict(params_to_state_dict(params), strict=True, assign=True)
    return D.to(device)


def _check_device(device) -> None:
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the port on the CPU")


def load_snapshot(path: str, device="cuda") -> GMain:
    """The snapshot's Gs as the port's ``GMain`` on ``device``."""
    _check_device(device)
    snap = read_snapshot(path)
    return gmain_from_params(snap["Gs"]["config"], snap["Gs"]["params"], device)


def load_networks(path: str, device="cuda") -> Tuple[GMain, Discriminator, GMain]:
    """The snapshot's (G, D, Gs) on ``device``, parameters in their stored
    dtype, as the JAX package's ``training_loop.load_snapshot`` reads them."""
    _check_device(device)
    snap = read_snapshot(path)
    G = gmain_from_params(snap["G"]["config"], snap["G"]["params"], device)
    D = discriminator_from_params(snap["D"]["config"], snap["D"]["params"], device)
    Gs = gmain_from_params(snap["Gs"]["config"], snap["Gs"]["params"], device)
    return G, D, Gs


def load_train_state(path: str, device="cuda"):
    """The resume path of the JAX training loop: the snapshot's G, D and Gs
    with fresh Adam moments, ``pl_mean`` 0 and step 0
    (``training.train_state.create_train_state``)."""
    from .training.train_state import create_train_state
    return create_train_state(*load_networks(path, device))
