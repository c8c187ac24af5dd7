"""The local model cache and the repository fetch.

Port of ``nequip_tpu/utils/model_cache.py``: ``nequip.net:group/model:version``
ids resolve to archives in a cache directory (``$NEQUIP_CACHE_DIR``, else
``~/.nequip_tpu/model_cache``, the JAX package's, so one cache serves both).
An id that is not in the cache is fetched through the repository client
(``model_repository.py``) into the cache; where the repository cannot be
reached, the error names the path to place the archive at.
"""

from __future__ import annotations

import http.client
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
    """The local path of a model id: the cached archive, or the repository's
    artifact fetched into the cache.  A model the repository does not know
    raises ``ModelNotFoundError``; a repository that cannot be reached
    ``FileNotFoundError`` with the path to place the archive at."""
    path = model_id_to_path(model_id)
    if os.path.exists(path):
        return path
    from .model_repository import NequIPNetAPIClient

    client = NequIPNetAPIClient()
    try:
        return client.download_model(model_id[len(_SCHEME):], path)
    except (OSError, http.client.HTTPException) as e:  # urllib's errors are OSErrors
        raise FileNotFoundError(
            f"model {model_id!r} is not in the local cache and the repository ({client.base_url}) is "
            f"unreachable ({type(e).__name__}: {e}); place the package archive at {path}"
        ) from e
