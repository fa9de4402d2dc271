"""The port's live runner (`apps/run_live.py`) and stream feeder
(`tools/stream_feeder.py`) against the JAX package's: the directory
stream's pairing, growth check, order and idle timeout on the same
directory, the stdin transport's parsing, and the runner on a fed stream
against the offline runner on the same frames."""

import io
import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from supersurfel_fusion_tpu.apps import run_live as jlive
from supersurfel_fusion_tpu_torch import synthetic
from supersurfel_fusion_tpu_torch.apps import run_benchmark, run_live
from supersurfel_fusion_tpu_torch.config import PipelineConfig
from supersurfel_fusion_tpu_torch.io.tum import read_trajectory_file
from supersurfel_fusion_tpu_torch.tools import stream_feeder

torch.set_num_threads(1)


def _consume(stream, out):
    for ts, rgb, depth in stream:
        out.append((ts, os.path.basename(rgb), os.path.basename(depth),
                    os.path.getsize(rgb)))


def _write(path, data):
    with open(path, "wb") as f:
        f.write(data)


def test_directory_stream_matches_jax(tmp_path):
    """Both packages' streams poll one directory while a writer fills it:
    a pair at once, an rgb whose depth comes late, an rgb still growing,
    a pair chosen among two depths by the closest stamp, an rgb with no
    depth within 0.02 s, then silence. Both yield the same (stamp, rgb,
    depth) sequence: each pair once, the growing file only once complete,
    the late pair after the ones ready before it, then the idle timeout
    ends both."""
    root = tmp_path / "live"
    (root / "rgb").mkdir(parents=True)
    (root / "depth").mkdir()
    streams = {name: mod.DirectoryStream(str(root), poll_interval=0.05,
                                         idle_timeout=1.0)
               for name, mod in (("port", run_live), ("jax", jlive))}
    got = {k: [] for k in streams}
    threads = [threading.Thread(target=_consume, args=(s, got[k]))
               for k, s in streams.items()]
    for th in threads:
        th.start()

    def rgb(ts, data=b"rgb-bytes"):
        _write(root / "rgb" / f"{ts:.6f}.png", data)

    def depth(ts, data=b"depth-bytes"):
        _write(root / "depth" / f"{ts:.6f}.png", data)

    rgb(1.0), depth(1.0), rgb(1.033333), depth(1.066667)
    growing = root / "rgb" / f"{1.066667:.6f}.png"
    for _ in range(40):                      # grows for 0.4 s
        with open(growing, "ab") as f:
            f.write(b"x" * 100)
        time.sleep(0.01)
    time.sleep(0.5)
    depth(1.033333)                          # the late depth
    time.sleep(0.4)
    rgb(1.1), depth(1.099), depth(1.11)      # closest depth wins
    rgb(2.0), depth(2.05)                    # no depth within 0.02 s
    t_last = time.time()
    for th in threads:
        th.join(timeout=10.0)
        assert not th.is_alive(), "the idle timeout did not end the stream"
    assert time.time() - t_last >= 0.9
    assert got["port"] == got["jax"]
    assert [g[:3] for g in got["port"]] == [
        (1.0, "1.000000.png", "1.000000.png"),
        (1.066667, "1.066667.png", "1.066667.png"),
        (1.033333, "1.033333.png", "1.033333.png"),
        (1.1, "1.100000.png", "1.099000.png")]
    assert got["port"][1][3] == 4000         # consumed once complete


def test_stdin_stream_matches_jax(monkeypatch):
    text = ("# rgb depth stamp\n\n"
            "rgb/1.000000.png depth/1.000000.png\n"
            "rgb/1.033333.png depth/1.033000.png 7.5\n"
            "lonely.png\n"
            "rgb/not-a-stamp.png depth/x.png\n")
    port = list(run_live.stdin_stream(io.StringIO(text)))
    monkeypatch.setattr(sys, "stdin", io.StringIO(text))
    assert port == list(jlive.stdin_stream())
    assert port == [(1.0, "rgb/1.000000.png", "depth/1.000000.png"),
                    (7.5, "rgb/1.033333.png", "depth/1.033000.png"),
                    (-1.0, "rgb/not-a-stamp.png", "depth/x.png")]
    monkeypatch.setattr(sys, "stdin", io.StringIO(text))
    assert list(run_live.stdin_stream()) == port


@pytest.fixture(scope="module")
def sequence(tmp_path_factory):
    """Two 640x480 frames of the static clip as a TUM directory."""
    root = tmp_path_factory.mktemp("seq") / "rgbd_dataset_freiburg1_syn"
    clip = synthetic.frames(PipelineConfig().cam, 2)
    stamps = synthetic.write_tum_sequence(str(root), clip)
    return str(root), stamps


def test_live_runner_on_a_fed_stream_equals_offline_runner(sequence,
                                                           tmp_path,
                                                           capsys):
    """The feeder writes the two frames into a watch directory from a
    thread at 30 fps; `run_live --watch --cpu` consumes both, once each, in
    stamp order, and its pose lines equal the offline runner's on the same
    frames. `--render-every 1` writes the images of every frame (the
    superpixels, the slanted planes and the model; the MOD mask with MOD
    on), `--save-model` the model as the offline runner exports it."""
    seq, stamps = sequence
    watch = tmp_path / "watch"
    fed = []
    feeder = threading.Thread(target=stream_feeder.feed, args=(
        seq, str(watch), 30.0, 0, lambda i, ts, t: fed.append(ts)))
    feeder.start()
    live_out = tmp_path / "live.txt"
    renders = tmp_path / "renders"
    model = tmp_path / "model.txt"
    rc = run_live.main(["--watch", str(watch), "--cpu", "--quiet",
                        "--idle-timeout", "2", "--out", str(live_out),
                        "--render-every", "1", "--render-dir", str(renders),
                        "--save-model", str(model)])
    feeder.join(timeout=30.0)
    assert rc == 0 and not feeder.is_alive()
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["frames"] == 2 and res["trajectory"] == str(live_out)
    assert {"frame", "ssf.vo", "vo.pnp"} <= set(res["stage_ms"])
    assert 0 < res["stage_ms"]["vo.pnp"] < res["stage_ms"]["frame"]
    assert res["graphs"] == {"captured": [], "capture_ms": 0.0,
                             "replays_per_frame": 0.0,
                             "eager_per_frame": 9.0,
                             "part_replays_per_frame": 0.0,
                             "part_eager_per_frame": 0.0,
                             "eager_ops_per_frame": 0.0}
    assert fed == stamps
    live = read_trajectory_file(str(live_out))
    assert sorted(live) == list(live) == stamps

    off_out = tmp_path / "offline.txt"
    off_model = tmp_path / "offline_model.txt"
    assert run_benchmark.main(["--dataset", seq, "--cpu", "--quiet",
                               "--out", str(off_out), "--save-model",
                               str(off_model)]) == 0
    off = read_trajectory_file(str(off_out))
    for ts in stamps:
        np.testing.assert_allclose(live[ts], off[ts], atol=1e-6)

    names = sorted(os.listdir(renders))
    assert names == sorted(f"{k}_{n:05d}.png" for n in (1, 2)
                           for k in ("superpixels", "slanted", "model"))
    # the same model export as the offline runner's (after two frames no
    # surfel passes the export's confidence threshold: both files empty)
    assert model.read_text() == off_model.read_text()


def test_live_runner_needs_a_card_or_cpu(tmp_path, capsys):
    """Without a card and without --cpu the runner exits 2 and writes
    nothing."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert run_live.main(["--watch", str(tmp_path),
                          "--out", str(tmp_path / "t.txt")]) == 2
    assert "device='cpu'" in capsys.readouterr().err
    assert not (tmp_path / "t.txt").exists()


def test_stdin_runner_with_missing_weights_runs_simple_mod(sequence,
                                                           tmp_path,
                                                           monkeypatch,
                                                           capsys):
    """`--stdin` on one frame; `--yolo` with weights that are missing runs
    the simple MOD path and says so on stderr, as the JAX runner does."""
    seq, stamps = sequence
    line = (f"{seq}/rgb/{stamps[0]:.6f}.png "
            f"{seq}/depth/{stamps[0]:.6f}.png\n")
    monkeypatch.setattr(sys, "stdin", io.StringIO(line))
    out = tmp_path / "stdin.txt"
    assert run_live.main(["--stdin", "--cpu", "--yolo", "--weights",
                          str(tmp_path / "absent.npz"), "--out",
                          str(out)]) == 0
    cap = capsys.readouterr()
    assert "not found; running the simple MOD path" in cap.err
    assert json.loads(cap.out.strip().splitlines()[-1])["frames"] == 1
    assert list(read_trajectory_file(str(out))) == stamps[:1]
