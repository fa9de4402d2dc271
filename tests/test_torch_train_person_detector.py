"""PyTorch port vs the JAX package: training the person detector
(`supersurfel_fusion_tpu_torch/tools/train_person_detector.py` against the
repository's `tools/train_person_detector.py`), on the CPU.

The JAX trainer keeps its loss, step and forward inside `train()`, so the
port is held against the whole `train(args)` on a small label file written
here from a seed (16 frames at 96x128): its stdout's losses (read exactly
through its numpy module), the inputs of every jitted step, and the weights
it writes. The label filter, the box extraction and the evaluation are
module-level there and are called directly."""

import argparse
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from supersurfel_fusion_tpu.models import person_detector as jpd
from supersurfel_fusion_tpu_torch import convert
from supersurfel_fusion_tpu_torch.models import person_detector as tpd
from supersurfel_fusion_tpu_torch.tools import train_person_detector as tt
from supersurfel_fusion_tpu_torch.utils import prng

from test_torch_prng import NORMAL_ULP

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
WEIGHTS = ROOT / "weights" / "person_detector.npz"
EVAL_DATA = ROOT / "artifacts" / "mod_boxes_eval.npz"


def _jax_trainer():
    spec = importlib.util.spec_from_file_location(
        "jax_train_person_detector",
        ROOT / "tools" / "train_person_detector.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jt = _jax_trainer()


def write_labels(path, n=16, h=96, w=128, seed=0):
    """A label file in the layout `--collect` writes: uint8 grey, uint16
    depth, up to 3 boxes per frame (every fourth frame a negative), the
    boxes drawn brighter than the noise, and provenance keys."""
    rng = np.random.default_rng(seed)
    gray = rng.integers(0, 256, (n, h, w), dtype=np.uint8)
    depth = rng.integers(0, 40000, (n, h, w)).astype(np.uint16)
    boxes = np.zeros((n, 3, 4), np.float32)
    counts = np.zeros(n, np.int32)
    for i in range(n):
        k = int(rng.integers(1, 4)) if i % 4 else 0
        for b in range(k):
            x0, y0 = rng.uniform(0, w - 40), rng.uniform(0, h - 50)
            boxes[i, b] = [x0, y0, x0 + rng.uniform(12, 40),
                           y0 + rng.uniform(16, 50)]
            x0, y0, x1, y1 = boxes[i, b].astype(int)
            gray[i, y0:y1, x0:x1] = 230
        counts[i] = k
    np.savez(path, gray=gray, depth=depth, boxes=boxes, counts=counts,
             start=3, end=3 + n, dataset="synthetic")
    return path


def test_init_params_structure():
    """JAX's `init_params()`: the same keys, shapes and dtypes, every
    weight within test_torch_prng.NORMAL_ULP f32 ulp of JAX's (XLA's log1p
    inside erfinv is its own approximation), the biases exact; another
    key gives other weights, the same key the same ones."""
    jp = {k: np.asarray(v) for k, v in jpd.init_params().items()}
    tp = tpd.init_params()
    assert set(tp) == set(jp)
    for k in jp:
        assert tp[k].shape == jp[k].shape and tp[k].dtype == np.float32, k
        ulp = np.abs(tp[k].view(np.int32).astype(np.int64)
                     - jp[k].view(np.int32).astype(np.int64)).max()
        assert ulp <= NORMAL_ULP, k
        if k.endswith("_b"):
            np.testing.assert_array_equal(tp[k], jp[k], err_msg=k)
    assert tp["heat_b"].tolist() == [-4.0]
    again = tpd.init_params(prng.PRNGKey(0))
    other = tpd.init_params(prng.PRNGKey(1))
    assert all(np.array_equal(tp[k], again[k]) for k in tp)
    assert not np.array_equal(tp["conv1_w"], other["conv1_w"])


def _jax_forward_maps(params, g, d):
    """The JAX trainer's `forward_maps` (tools/train_person_detector.py,
    inside `train`)."""
    x = jnp.stack([g / 255.0, jnp.clip(d, 0, 5.0) / 5.0], axis=-1)
    for i, (_, s) in enumerate(jpd._STAGES):
        x = jax.nn.relu(jax.lax.conv_general_dilated(
            x, params[f"conv{i}_w"], (s, s), "SAME",
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
        ) + params[f"conv{i}_b"])
    heat = jax.lax.conv_general_dilated(
        x, params["heat_w"], (1, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))[..., 0] \
        + params["heat_b"][0]
    size = jax.lax.conv_general_dilated(
        x, params["size_w"], (1, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC")) + params["size_b"]
    return heat, size


def test_forward_maps_matches_jax():
    """JAX's `init_params()` carried across: the batched logits and sizes
    within 1e-5 at two frame sizes (the "SAME" padding is asymmetric at
    odd sizes); `to_params` gives the JAX dict back exactly."""
    jp = {k: np.asarray(v) for k, v in jpd.init_params().items()}
    det = convert.detector_from_numpy(jp)
    back = convert.to_params(det)
    assert set(back) == set(jp)
    for k in jp:
        np.testing.assert_array_equal(back[k], jp[k], err_msg=k)
    rng = np.random.default_rng(3)
    for shape in ((3, 96, 128), (2, 100, 150)):
        g = rng.uniform(0, 255, shape).astype(np.float32)
        d = rng.uniform(0, 6, shape).astype(np.float32)
        hj, sj = _jax_forward_maps(jp, jnp.asarray(g), jnp.asarray(d))
        ht, st = det.forward_maps(torch.from_numpy(g), torch.from_numpy(d))
        np.testing.assert_allclose(ht.numpy(), np.asarray(hj), rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=0,
                                   atol=1e-5)
    # the detector's single-frame maps are the batched forward's (a batch
    # of one convolves in another blocking: within 1e-6)
    heat, size = det.maps(torch.from_numpy(g[0]), torch.from_numpy(d[0]))
    torch.testing.assert_close(heat, torch.sigmoid(ht[0]), rtol=0, atol=1e-6)
    torch.testing.assert_close(size, st[0], rtol=0, atol=1e-6)


def test_labels_and_boxes_match_jax():
    """`_filter_labels` (with and without the area and aspect filter; the
    area is a fraction of a 640x480 frame whatever the labels' size) and
    `_boxes_from_mask` on random masks: exact."""
    rng = np.random.default_rng(11)
    n = 40
    counts = rng.integers(0, 6, n).astype(np.int32)
    xy = rng.uniform(0, 600, (n, 5, 2))
    wh = rng.uniform(-10, 400, (n, 5, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    for lo, hi in ((0.0, 1.0), (0.02, 0.5), (0.0, 0.1), (0.05, 1.0)):
        bj, cj = jt._filter_labels(boxes, counts, lo, hi)
        bt, ct = tt._filter_labels(boxes, counts, lo, hi)
        np.testing.assert_array_equal(ct, cj)
        np.testing.assert_array_equal(bt, bj)
        assert ct.dtype == cj.dtype and bt.dtype == bj.dtype
    assert 0 < cj.sum() < counts.sum()
    n_boxes = 0
    for p in (0.1, 0.3, 0.6):
        for _ in range(4):
            dyn = rng.random((30, 40)) < p
            bj = jt._boxes_from_mask(dyn, 16)
            bt = tt._boxes_from_mask(dyn, 16)
            np.testing.assert_array_equal(bt, bj)
            n_boxes += len(bj)
    assert n_boxes > 10


class _Means:
    """The JAX trainer's numpy module, recording every `np.mean` (the
    per-epoch losses, which its stdout rounds to 4 decimals)."""

    def __init__(self):
        self.values = []

    def __getattr__(self, name):
        return getattr(np, name)

    def mean(self, *a, **kw):
        self.values.append(np.mean(*a, **kw))
        return self.values[-1]


@pytest.mark.parametrize("augment,carry", [(False, True), (True, True),
                                           (False, False)],
                         ids=["plain", "augment", "own_init"])
def test_train_matches_jax(augment, carry, tmp_path, monkeypatch):
    """JAX's `train()` against the port's, 16 frames at 96x128, batch 4,
    2 epochs (3 schedule steps per epoch, 4 run): from JAX's
    `init_params()` carried across, or (`own_init`) each from its own
    default init, the port's drawn by `utils/prng.py`. Every step's inputs
    (the sampled frames, their targets, the flips) exact; the loss of
    every epoch within 1e-5 relative; every step's learning rate equal to
    optax's schedule; the final parameters within 1e-4 (Adam divides by
    sqrt(nu): a weight whose gradients are near zero moves by up to lr per
    step on rounding alone)."""
    data = write_labels(tmp_path / "labels.npz")
    args = argparse.Namespace(data=str(data), eval_data=None,
                              out=str(tmp_path / "jax.npz"), epochs=2,
                              batch=4, lr=3e-4, min_area=0.0, max_area=1.0,
                              augment=augment)
    means = _Means()
    monkeypatch.setattr(jt, "np", means)
    jax_inputs = []
    real_jit = jax.jit

    def spy_jit(fn, *a, **kw):
        jitted = real_jit(fn, *a, **kw)
        if a or kw:
            return jitted

        def run(*a):
            jax_inputs.append([np.asarray(v) for v in a[2:]])
            return jitted(*a)
        return run

    monkeypatch.setattr(jax, "jit", spy_jit)
    jt.train(args)
    monkeypatch.undo()

    port_inputs = []
    step = tt.Trainer.step

    def spy_step(self, *batch):
        port_inputs.append([v.numpy().copy() for v in batch])
        return step(self, *batch)

    monkeypatch.setattr(tt.Trainer, "step", spy_step)
    init = {k: np.asarray(v) for k, v in jpd.init_params().items()}
    targs = argparse.Namespace(**vars(args), device="cpu")
    targs.out = str(tmp_path / "port.npz")
    res = tt.train(targs, params=init if carry else None)

    assert len(port_inputs) == len(jax_inputs) == 8
    for k, (pi, ji) in enumerate(zip(port_inputs, jax_inputs)):
        pi[1] = pi[1].view(np.uint16)
        for a, b in zip(pi, ji):
            np.testing.assert_array_equal(a, b, err_msg=str(k))
    np.testing.assert_allclose(res["epoch_loss"], means.values, rtol=1e-5,
                               atol=0)
    sched = optax.cosine_decay_schedule(3e-4, res["n_steps"], 0.05)
    assert res["n_steps"] == 6
    assert res["lr"] == [float(sched(jnp.int32(i))) for i in range(8)]
    jw, tw = np.load(args.out), np.load(targs.out)
    assert set(jw.files) == set(tw.files)
    for k in jw.files:
        if k.startswith("label_"):
            np.testing.assert_array_equal(tw[k], jw[k])
        else:
            np.testing.assert_allclose(tw[k], jw[k], rtol=0, atol=1e-4,
                                       err_msg=k)
            assert np.abs(jw[k] - init[k]).max() > 5e-4, k
    if augment:
        flips = [np.array_equal(p[2], p[2][:, :, ::-1]) for p in port_inputs]
        assert not all(flips)


def test_default_schedule_matches_optax():
    """The committed weights' run: 716 frames, batch 8, 30 epochs: 2640
    schedule steps, 2670 run, the last 30 at lr * alpha exactly. Over the
    decay the port's float32 evaluation is no farther from optax's, eager
    or jitted, than those two are from each other (XLA folds pi / n_steps
    and fuses the affine tail: up to 10 ulp apart)."""
    n_steps = tt.schedule_steps(716, 8, 30)
    assert n_steps == 2640 and len(range(0, 716 - 8 + 1, 8)) * 30 == 2670
    sched = optax.cosine_decay_schedule(3e-4, n_steps, 0.05)
    counts = jnp.arange(2670, dtype=jnp.int32)
    jitted = np.asarray(jax.jit(jax.vmap(sched))(counts))
    eager = np.array([sched(c) for c in counts], np.float32)
    port = np.array([tt.learning_rate(i, 3e-4, n_steps)
                     for i in range(2670)], np.float32)
    spread = np.abs(eager - jitted).max()
    assert 0 < spread < 1e-6 * 3e-4
    for ref in (eager, jitted):
        assert np.abs(port - ref).max() <= spread
    assert (port[2640:] == np.float32(3e-4) * np.float32(0.05)).all()
    assert (port[2640:] == jitted[2640:]).all()
    assert (port[2640:] == eager[2640:]).all()


def _parse_counts(line):
    """(hits, total, n_match, n_det) from an `_eval_boxes` line."""
    rec = line.split("recall@IoU0.3 ")[1].split(" =")[0]
    prec = line.split("precision ")[1].split(" =")[0]
    return (*map(int, rec.split("/")), *map(int, prec.split("/")))


def test_eval_boxes_and_checkpoint_match_jax(tmp_path, capsys):
    """`_eval_boxes` on 8 held-out frames of the committed labels with the
    committed weights at three thresholds: the same hits, label totals,
    matches and detections as JAX. A port-written checkpoint (layout,
    provenance keys) read by JAX's `load_params` and `detect`: the boxes
    within 1e-4 px of the port's."""
    with np.load(EVAL_DATA) as ed:
        idx = np.arange(0, 128, 16)
        g, d = ed["gray"][idx], ed["depth"][idx]
        b, c = ed["boxes"][idx], ed["counts"][idx]
    det = tpd.load_detector(WEIGHTS, "cpu")
    params = jpd.load_params(str(WEIGHTS))
    n_det = 0
    for th in (0.3, 0.15, 0.1):
        capsys.readouterr()
        jt._eval_boxes(params, "jax", g, d, b, c, thresh=th)
        jline = capsys.readouterr().out
        score = tt._eval_boxes(det, "port", g, d, b, c, thresh=th)
        hits, tot, nmatch, ndet = _parse_counts(jline)
        assert (score.hits, score.total, score.n_match, score.n_det) == (
            hits, tot, nmatch, ndet), (th, jline)
        n_det += ndet
        assert tot == int(c.sum())
    assert n_det > 0 and score.hits > 0

    # a checkpoint the port's command line writes, read by the JAX package
    labels = write_labels(tmp_path / "labels.npz")
    path = tmp_path / "ckpt.npz"
    assert tt.main(["--train", "--data", str(labels), "--out", str(path),
                    "--epochs", "1", "--batch", "4", "--device", "cpu"]) == 0
    with np.load(path) as ck:
        assert ck["label_dataset"] == "synthetic" and ck["label_start"] == 3
    back = jpd.load_params(str(path))
    assert set(back) == set(jpd.init_params())
    port = tpd.load_detector(path, "cpu")
    gray = torch.from_numpy(g[1].astype(np.float32))
    depth = torch.from_numpy(d[1].astype(np.float32) / 5000.0)
    for th in (0.0, 0.3):
        dt = port(gray, depth, score_thresh=th)
        dj = jpd.detect(back, jnp.asarray(gray.numpy()),
                        jnp.asarray(depth.numpy()), score_thresh=th)
        np.testing.assert_allclose(dt.boxes.numpy(), np.asarray(dj.boxes),
                                   rtol=0, atol=1e-4)
        np.testing.assert_array_equal(dt.valid.numpy(), np.asarray(dj.valid))
    assert tt.main(["--eval-only", "--data", str(labels), "--weights",
                    str(path), "--thresh", "0.1", "0.3", "--device",
                    "cpu"]) == 0
    assert tt.main(["--collect"]) == 1
