"""Prioritized DCI, the host index of the IMLE retrieval's ``dci`` backend:
the JAX package's C++ sources (``csrc/``), built with ``g++`` at first use
(``build.py``) and bound with ctypes (``dci.py``). The projections of the
points onto the index's directions are one matrix product on the card
(``training/imle.py``); the library sorts the tables and walks them."""

from .dci import DCI  # noqa: F401
