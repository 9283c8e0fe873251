"""The port's fsspec mirror (``io/remote.py``, ``MetricsWriter(remote_uri=)``
and ``apps.train --remote-dir``) on fsspec's in-memory filesystem, as the
JAX package's own tests run it (``tests/test_io.py``)."""
import json
import sys
import uuid

import fsspec
import pytest
import torch
from fsspec.implementations.memory import MemoryFileSystem

from mlp_ppo_2ply_multi_tpu_torch.apps import train
from mlp_ppo_2ply_multi_tpu_torch.io import checkpoint, metrics, remote


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _uri():
    return f"memory://port_mirror_{uuid.uuid4().hex}"


def test_sync_dir_uploads_skips_unchanged_and_swallows_failures(tmp_path, monkeypatch):
    local = tmp_path / "run"
    local.mkdir()
    (local / "metrics.jsonl").write_text('{"step": 1}\n')
    (local / "sub").mkdir()
    (local / "sub" / "events.bin").write_bytes(b"\x00\x01")
    uri = _uri()
    root = uri[len("memory://"):]
    puts = []
    real_put = MemoryFileSystem.put_file
    monkeypatch.setattr(MemoryFileSystem, "put_file",
                        lambda self, src, dst, **kw: puts.append(dst) or real_put(
                            self, src, dst, **kw))
    assert remote.sync_dir(str(local), uri)
    fs = fsspec.filesystem("memory")
    assert fs.cat(f"/{root}/metrics.jsonl") == b'{"step": 1}\n'
    assert fs.cat(f"/{root}/sub/events.bin") == b"\x00\x01"
    assert len(puts) == 2
    # nothing changed: nothing uploaded
    assert remote.sync_dir(str(local), uri)
    assert len(puts) == 2
    # a changed file is uploaded again, the unchanged one is not
    (local / "metrics.jsonl").write_text('{"step": 1}\n{"step": 2}\n')
    assert remote.sync_dir(str(local), uri)
    assert len(puts) == 3 and puts[-1].endswith("metrics.jsonl")
    assert b'"step": 2' in fs.cat(f"/{root}/metrics.jsonl")
    # a bogus protocol: printed, swallowed, False
    assert not remote.sync_dir(str(local), "no-such-proto://x/y")


def test_remote_mirror_rate_limits_and_syncs_on_close(tmp_path, monkeypatch):
    calls = []
    monkeypatch.setattr(remote, "sync_dir", lambda d, u: calls.append((d, u)) or True)
    m = remote.RemoteMirror(str(tmp_path), "memory://x", interval_s=3600)
    m.maybe_sync()
    m.maybe_sync()  # inside the interval
    assert len(calls) == 1
    m.close()
    assert len(calls) == 2
    remote.RemoteMirror(str(tmp_path), None).close()  # no URI: nothing
    assert len(calls) == 2


def test_metrics_writer_mirrors_its_run_dir(tmp_path):
    uri = _uri()
    w = metrics.MetricsWriter(str(tmp_path), run_name="r", remote_uri=uri)
    w.scalars(1, {"loss": 0.5})
    w.close()
    fs = fsspec.filesystem("memory")
    assert b'"loss": 0.5' in fs.cat(f"/{uri[len('memory://'):]}/metrics.jsonl")


def test_train_cli_mirrors_runs_and_checkpoints(tmp_path):
    """``--remote-dir memory://...`` leaves the metrics file under runs/
    and the checkpoint under checkpoints/, as the JAX CLI does."""
    uri = _uri()
    rc = train.main([
        "--device", "cpu", "--mode", "continuous", "--small-movegen", "--batch-games", "8",
        "--updates", "2", "--steps-per-update", "4", "--checkpoint-dir", str(tmp_path / "ck"),
        "--metrics-dir", str(tmp_path / "runs"), "--remote-dir", uri + "/", "--log-every", "1",
    ])
    assert rc == 0
    fs = fsspec.filesystem("memory")
    root = "/" + uri[len("memory://"):]
    lines = [f for f in fs.find(root + "/runs") if f.endswith("metrics.jsonl")]
    assert len(lines) == 1
    recs = [json.loads(x) for x in fs.cat(lines[0]).decode().splitlines()]
    assert sum("loss" in r for r in recs) == 2
    saved = fs.ls(root + "/checkpoints", detail=False)
    assert [s.rsplit("/", 1)[-1] for s in saved] == [
        f"ckpt_{s}.pt" for s in checkpoint.steps(str(tmp_path / "ck"))]


def test_train_cli_refuses_remote_dir_without_fsspec(tmp_path, monkeypatch, capsys):
    """Where fsspec does not import, ``--remote-dir`` exits 2 up front and
    names fsspec (the JAX CLI would print a failure at every sync)."""
    monkeypatch.setitem(sys.modules, "fsspec", None)
    assert not remote.available()
    with pytest.raises(SystemExit) as e:
        train.main(["--device", "cpu", "--remote-dir", "memory://x",
                    "--checkpoint-dir", str(tmp_path / "ck"),
                    "--metrics-dir", str(tmp_path / "runs")])
    assert e.value.code == 2
    assert "fsspec" in capsys.readouterr().err
    assert not (tmp_path / "runs").exists()
