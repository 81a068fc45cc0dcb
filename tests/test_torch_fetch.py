"""Port parity: the ``fetch`` downloader (``data/registry.py::fetch_free_convection``, ``cli/main.py::cmd_fetch``).

No test touches the network: ``urllib.request.urlopen`` is replaced by a
local byte stream, or by one that fails as an offline machine does. Both
packages call ``urllib.request.urlopen`` at run time, so one replacement
serves both commands, whose files and printed lines must agree.
"""

import importlib
import io
import os
import urllib.error
import urllib.request

import numpy as np
import pytest

from climateparameterizations_jl_tpu.data import registry as jreg
from climateparameterizations_jl_tpu_torch.cli import main as tcli
from climateparameterizations_jl_tpu_torch.data import registry as treg

jcli = importlib.import_module("climateparameterizations_jl_tpu.cli.main")
PAYLOAD = np.random.default_rng(0).integers(0, 256, size=(3 << 20) + 17, dtype=np.uint8).tobytes()


class _Stream(io.BytesIO):
    """What ``urlopen`` returns: a readable context manager; ``fail_after`` bytes, then an ``OSError``."""

    def __init__(self, data: bytes, fail_after: int | None = None):
        super().__init__(data)
        self.fail_after = fail_after

    def read(self, n=-1):
        if self.fail_after is not None and self.tell() >= self.fail_after:
            raise OSError("connection reset")
        return super().read(n)


@pytest.fixture
def served(monkeypatch):
    """``urlopen`` serving ``PAYLOAD`` for every URL; records the URLs asked for."""
    urls = []

    def urlopen(url, timeout=None):
        urls.append((url, timeout))
        return _Stream(PAYLOAD)

    monkeypatch.setattr(urllib.request, "urlopen", urlopen)
    return urls


@pytest.fixture
def offline(monkeypatch):
    def urlopen(url, timeout=None):
        raise urllib.error.URLError("[Errno -3] Temporary failure in name resolution")

    monkeypatch.setattr(urllib.request, "urlopen", urlopen)


@pytest.mark.parametrize("sim_id", range(1, 10))
def test_url_equals_jax(sim_id):
    assert treg.free_convection_url(sim_id) == jreg.free_convection_url(sim_id)


@pytest.mark.parametrize("sim_id", [0, 10])
def test_unknown_id_raises(sim_id):
    with pytest.raises(KeyError, match="1..9"):
        treg.free_convection_url(sim_id)


def test_download_writes_the_stream_once(tmp_path, served):
    path = treg.fetch_free_convection(3, str(tmp_path), timeout=5.0)
    assert path == str(tmp_path / "free_convection_3" / "instantaneous_statistics_with_halos.jld2")
    assert open(path, "rb").read() == PAYLOAD
    assert served == [(treg.free_convection_url(3), 5.0)]
    assert os.listdir(tmp_path / "free_convection_3") == ["instantaneous_statistics_with_halos.jld2"]
    assert treg.fetch_free_convection(3, str(tmp_path)) == path and len(served) == 1  # kept
    treg.fetch_free_convection(3, str(tmp_path), force=True)
    assert len(served) == 2 and open(path, "rb").read() == PAYLOAD


def test_offline_raises_connection_error_and_leaves_no_part(tmp_path, offline):
    with pytest.raises(ConnectionError, match="free_convection_4/instantaneous_statistics_with_halos.jld2"):
        treg.fetch_free_convection(4, str(tmp_path))
    assert os.listdir(tmp_path / "free_convection_4") == []


def test_interrupted_download_leaves_no_part(tmp_path, monkeypatch):
    monkeypatch.setattr(urllib.request, "urlopen", lambda url, timeout=None: _Stream(PAYLOAD, fail_after=1 << 20))
    with pytest.raises(ConnectionError, match="connection reset"):
        treg.fetch_free_convection(5, str(tmp_path))
    assert os.listdir(tmp_path / "free_convection_5") == []


def test_fetch_command_matches_jax(tmp_path, served, capsys):
    argv = ["fetch", "--sim-ids", "1,9", "--timeout", "7"]
    assert jcli.main([*argv, "--data-dir", str(tmp_path / "jax")]) == 0
    want = capsys.readouterr().out.replace(str(tmp_path / "jax"), "DIR")
    assert tcli.main([*argv, "--data-dir", str(tmp_path / "port")]) == 0
    got = capsys.readouterr().out.replace(str(tmp_path / "port"), "DIR")
    assert got == want and got.count("fetch[") == 2
    for i in (1, 9):
        rel = os.path.join(f"free_convection_{i}", "instantaneous_statistics_with_halos.jld2")
        assert open(tmp_path / "port" / rel, "rb").read() == open(tmp_path / "jax" / rel, "rb").read() == PAYLOAD


def test_fetch_command_offline(tmp_path, offline, capsys):
    """Offline every download fails: exit 1, one FAILED line per id and the summary, as the JAX command."""
    argv = ["fetch", "--sim-ids", "2,3", "--data-dir"]
    assert jcli.main([*argv, str(tmp_path / "jax")]) == 1
    want = capsys.readouterr().out.replace(str(tmp_path / "jax"), "DIR")
    assert tcli.main([*argv, str(tmp_path / "port")]) == 1
    got = capsys.readouterr().out.replace(str(tmp_path / "port"), "DIR")
    assert got.count("FAILED") == 2 and "fetch: 2/2 downloads failed" in got
    heads = lambda text: [line.split(" — ")[0] for line in text.splitlines()]  # noqa: E731
    assert heads(got) == heads(want)
