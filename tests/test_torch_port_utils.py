"""The port's utilities against the JAX package: the model repository and
its cache, the ranked logger, profiling and the global state.

The repository client and ``resolve_model_id`` run against a loopback
``http.server`` (``tests/unit/data/test_model_repository.py``'s fixture):
no test reaches the network.  ``TorchProfilerCallback`` traces steps of a
one-epoch ``nequip-torch-train`` run of the shipped LJ config on the CPU.
"""

import http.server
import json
import logging
import threading
from pathlib import Path

import pytest
import torch

from nequip_tpu.utils.global_state import get_latest_global_state as jax_global_state
from nequip_tpu.utils.model_repository import NequIPNetAPIClient as JClient

from nequip_tpu_torch import utils
from nequip_tpu_torch.utils import global_state, model_cache, model_repository, profiling
from nequip_tpu_torch.utils.config import instantiate, retarget

ROOT = Path(__file__).resolve().parents[1]
ARTIFACT_BYTES = b"PK\x03\x04 fake model package payload"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _RepoHandler(http.server.BaseHTTPRequestHandler):
    def log_message(self, *a):
        pass

    def do_GET(self):
        if self.path.startswith("/api/models/download/"):
            if "missing" in self.path.rsplit("/", 1)[1]:
                self.send_response(404)
                self.end_headers()
                return
            body = json.dumps({
                "modelId": "test-org/test-model:v1", "newerVersionId": "test-org/test-model:v2",
                "webUrl": "http://example/web",
                "artifact": {"downloadUrl": "/artifacts/test-model-v1.zip", "viewUrl": "http://example/view",
                             "hostName": "fixture", "doi": "10.0000/fake"},
            }).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.end_headers()
            self.wfile.write(body)
        elif self.path.startswith("/artifacts/"):
            self.send_response(200)
            self.end_headers()
            self.wfile.write(ARTIFACT_BYTES)
        else:
            self.send_response(404)
            self.end_headers()


@pytest.fixture()
def repo_server():
    server = http.server.HTTPServer(("127.0.0.1", 0), _RepoHandler)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{server.server_port}"
    server.shutdown()
    server.server_close()
    t.join(timeout=10)


def test_client_info_and_download(repo_server, tmp_path):
    client = model_repository.NequIPNetAPIClient(base_url=repo_server)
    info = client.get_model_download_info("test-org/test-model:v1")
    assert info == JClient(base_url=repo_server).get_model_download_info("test-org/test-model:v1")
    assert info.model_id == "test-org/test-model:v1" and info.newer_version_id == "test-org/test-model:v2"
    assert info.artifact.doi == "10.0000/fake"
    dest = tmp_path / "m.zip"
    assert client.download_model("test-org/test-model:v1", str(dest)) == str(dest)
    assert dest.read_bytes() == ARTIFACT_BYTES
    with pytest.raises(model_repository.ModelNotFoundError):
        client.get_model_download_info("test-org/missing-model:v1")
    with pytest.raises(ValueError, match="Invalid model_id"):
        client.get_model_download_info("not a valid id")
    assert model_repository.REPOSITORY_URL_ENV == "NEQUIP_TPU_REPOSITORY_URL"
    assert model_repository.NequIPNetAPIClient.MODEL_ID_PATTERN.pattern == JClient.MODEL_ID_PATTERN.pattern


def test_resolve_model_id_downloads_and_caches(repo_server, tmp_path, monkeypatch):
    monkeypatch.setenv(model_cache.CACHE_ENV, str(tmp_path / "cache"))
    monkeypatch.setenv(model_repository.REPOSITORY_URL_ENV, repo_server)
    mid = "nequip.net:test-org/test-model:v1"
    path = model_cache.resolve_model_id(mid)
    assert path == model_cache.model_id_to_path(mid) and Path(path).read_bytes() == ARTIFACT_BYTES
    # a cache hit works with the repository unreachable
    monkeypatch.setenv(model_repository.REPOSITORY_URL_ENV, "http://127.0.0.1:1")
    assert model_cache.resolve_model_id(mid) == path
    # a model the repository does not know is not an offline error
    monkeypatch.setenv(model_repository.REPOSITORY_URL_ENV, repo_server)
    with pytest.raises(model_repository.ModelNotFoundError):
        model_cache.resolve_model_id("nequip.net:test-org/missing-model:v1")


def test_resolve_model_id_offline_error(tmp_path, monkeypatch):
    monkeypatch.setenv(model_cache.CACHE_ENV, str(tmp_path / "cache"))
    monkeypatch.setenv(model_repository.REPOSITORY_URL_ENV, "http://127.0.0.1:1")
    mid = "nequip.net:test-org/test-model:v9"
    with pytest.raises(FileNotFoundError, match="unreachable") as e:
        model_cache.resolve_model_id(mid)
    assert model_cache.model_id_to_path(mid) in str(e.value)


# ---------------------------------------------------------------------------
# logger, profiling, global state
# ---------------------------------------------------------------------------
def test_ranked_logger_on_rank_zero(caplog):
    assert not torch.distributed.is_initialized()
    logger = utils.RankedLogger("nequip_tpu_torch.test")
    with caplog.at_level(logging.INFO, logger="nequip_tpu_torch.test"):
        logger.info("hello")
        logger.info("for rank 1", rank=1)
        logger.info("for rank 0", rank=0)
    assert [r.getMessage() for r in caplog.records] == ["[rank 0] hello", "[rank 0] for rank 0"]


def test_flops_per_step_counts_a_matmul():
    a, b = torch.randn(64, 64), torch.randn(64, 64)
    assert utils.flops_per_step(torch.mm, a, b) == 2 * 64 ** 3
    assert utils.mfu(2e12, 0.5, profiling.H100_BF16_FLOP_S) == pytest.approx(4e12 / 989e12)
    with pytest.raises(TypeError):
        utils.mfu(1.0, 1.0)  # no default peak: the caller names the card's


def test_trace_writes_a_chrome_trace(tmp_path):
    with utils.trace(str(tmp_path / "prof")) as prof:
        torch.mm(torch.randn(32, 32), torch.randn(32, 32))
    (trace_file,) = (tmp_path / "prof").glob("*.pt.trace.json")
    assert "traceEvents" in json.loads(trace_file.read_text())
    assert any("mm" in e.key for e in prof.key_averages())


def test_profiler_callback_traces_a_cli_run(tmp_path):
    """One epoch of nequip-torch-train on the shipped LJ config (8 frames,
    batch 2: 4 steps) with the callback as a config target; the window
    [1, 3) is traced.  The JAX package's class name resolves to it through
    retarget."""
    from nequip_tpu_torch.scripts.train import main

    log_dir = tmp_path / "profile"
    cb = f"[{{_target_: nequip_tpu_torch.utils.profiling.TorchProfilerCallback, log_dir: {log_dir}, " \
         "start_step: 1, end_step: 3}]"
    main(["-cn", "minimal_lj", "-cp", str(ROOT / "nequip_tpu_torch" / "configs"), "--device", "cpu",
          "++trainer.max_epochs=1", f"++trainer.ckpt_dir={tmp_path / 'ckpt'}", "++run=[train]",
          f"++trainer.callbacks={cb}"])
    (trace_file,) = log_dir.glob("*.pt.trace.json")
    assert json.loads(trace_file.read_text())["traceEvents"]
    jax_cfg = {"_target_": "nequip_tpu.utils.profiling.JaxProfilerCallback", "log_dir": str(log_dir),
               "start_step": 2, "end_step": 4}
    assert isinstance(instantiate(retarget(jax_cfg)), profiling.TorchProfilerCallback)
    with pytest.raises(ValueError, match="end_step"):
        profiling.TorchProfilerCallback(start_step=3, end_step=3)


def test_get_latest_global_state():
    state = utils.get_latest_global_state()
    assert set(state) == set(jax_global_state())
    assert state["x64"] is (torch.get_default_dtype() is torch.float64)
    old = global_state.tf32_enabled()
    try:
        global_state.set_tf32(True)
        assert utils.get_latest_global_state()["allow_tf32"] is True
    finally:
        global_state.set_tf32(old)
    prev = torch.get_default_dtype()
    try:
        torch.set_default_dtype(torch.float64)
        assert utils.get_latest_global_state()["x64"] is True
    finally:
        torch.set_default_dtype(prev)
