"""nequip.net model-repository REST client.

Port of ``nequip_tpu/utils/model_repository.py``: resolve
``group/model:version`` ids against the repository API and download the
model artifact, with stdlib ``urllib`` only.  The base URL is the JAX
package's ``$NEQUIP_TPU_REPOSITORY_URL`` (else ``https://www.nequip.net``),
which is also how tests point the client at a local server.
"""

from __future__ import annotations

import json
import logging
import os
import re
import shutil
import urllib.error
import urllib.request
from typing import NamedTuple, Optional
from urllib.parse import quote

log = logging.getLogger("nequip_tpu_torch")

REPOSITORY_URL_ENV = "NEQUIP_TPU_REPOSITORY_URL"
_DEFAULT_BASE_URL = "https://www.nequip.net"


class ModelArtifact(NamedTuple):
    download_url: str
    view_url: str
    host_name: str
    doi: str


class ModelDownloadInfo(NamedTuple):
    model_id: str
    newer_version_id: Optional[str]
    web_url: str
    artifact: Optional[ModelArtifact]


class ModelNotFoundError(Exception):
    """Raised when a model is not found in the repository."""


class NequIPNetAPIClient:
    MODEL_ID_PATTERN = re.compile(r"^([a-zA-Z0-9-]+)/([a-zA-Z0-9-]+):([a-zA-Z0-9-.]+)$")

    def __init__(self, base_url: Optional[str] = None, user_agent: Optional[str] = None):
        self.base_url = (base_url or os.environ.get(REPOSITORY_URL_ENV) or _DEFAULT_BASE_URL).rstrip("/")
        self.user_agent = user_agent or "NequipTPUTorchAPIClient/1.0 (Python)"

    def _get(self, url: str):
        req = urllib.request.Request(url, headers={"User-Agent": self.user_agent})
        return urllib.request.urlopen(req, timeout=60)  # nosec - a user-requested model

    def get_model_download_info(self, model_id: str) -> ModelDownloadInfo:
        if not self.MODEL_ID_PATTERN.match(model_id):
            raise ValueError(f"Invalid model_id format: {model_id}. "
                             "Expected format: namespace/model:version (e.g., 'my-org/my-model:v1')")
        url = f"{self.base_url}/api/models/download/{quote(model_id, safe='')}"
        try:
            with self._get(url) as resp:
                data = json.loads(resp.read().decode())
        except urllib.error.HTTPError as e:
            if e.code == 404:
                raise ModelNotFoundError(f"Model not found on the repository: {model_id}") from e
            raise
        a = data.get("artifact")
        if not a:
            raise ModelNotFoundError(f"No artifact found for model {model_id}; please file an issue.")
        return ModelDownloadInfo(
            model_id=data.get("modelId", model_id),
            newer_version_id=data.get("newerVersionId"),
            web_url=data.get("webUrl", ""),
            artifact=ModelArtifact(download_url=a.get("downloadUrl"), view_url=a.get("viewUrl", ""),
                                   host_name=a.get("hostName", ""), doi=a.get("doi", "")),
        )

    def download_model(self, model_id: str, dest_path: str) -> str:
        """Fetch the model artifact to ``dest_path`` (through a ``.part``
        file renamed when complete); returns the path."""
        info = self.get_model_download_info(model_id)
        if info.newer_version_id:
            log.warning(f"a newer version of {model_id} is available: {info.newer_version_id}")
        url = info.artifact.download_url
        if url.startswith("/"):
            url = self.base_url + url
        os.makedirs(os.path.dirname(dest_path) or ".", exist_ok=True)
        tmp = dest_path + ".part"
        with self._get(url) as resp, open(tmp, "wb") as f:
            shutil.copyfileobj(resp, f)
        os.replace(tmp, dest_path)
        log.info(f"downloaded {model_id} -> {dest_path}")
        return dest_path
