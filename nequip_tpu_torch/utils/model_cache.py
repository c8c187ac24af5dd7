"""The local model cache.

Port of the cache half of ``nequip_tpu/utils/model_cache.py``:
``nequip.net:group/model:version`` ids resolve to archives in a cache
directory (``$NEQUIP_CACHE_DIR``, else ``~/.nequip_tpu/model_cache``, the
JAX package's, so one cache serves both).  Fetching a model that is not in
the cache is not ported (the repository client needs the network): the
error names the path to place the archive at.
"""

from __future__ import annotations

import os

CACHE_ENV = "NEQUIP_CACHE_DIR"
_SCHEME = "nequip.net:"


def get_cache_dir() -> str:
    return os.environ.get(CACHE_ENV) or os.path.join(os.path.expanduser("~"), ".nequip_tpu", "model_cache")


def model_id_to_path(model_id: str) -> str:
    """'nequip.net:group/model:version' -> its archive's path in the cache."""
    if not model_id.startswith(_SCHEME):
        raise ValueError(f"model id {model_id!r} does not start with {_SCHEME!r}")
    name, _, version = model_id[len(_SCHEME):].partition(":")
    return os.path.join(get_cache_dir(), f"{name.replace('/', '__')}__{version or 'latest'}.zip")


def resolve_model_id(model_id: str) -> str:
    """The local path of a model id that is in the cache."""
    path = model_id_to_path(model_id)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"model {model_id!r} is not in the local cache; fetching is not ported: place the package archive at {path}"
        )
    return path
