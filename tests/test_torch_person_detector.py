"""PyTorch port vs the JAX package: the person detector with the committed
weights, on frames of the synthetic dynamic clip, on the CPU. One size
gives even feature maps and one odd ones, which pins JAX's asymmetric
"SAME" padding."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supersurfel_fusion_tpu.models import person_detector as jpd
from supersurfel_fusion_tpu_torch import config as tcfg
from supersurfel_fusion_tpu_torch import convert, synthetic
from supersurfel_fusion_tpu_torch.models import person_detector as tpd

# One intra-op thread: the suite runs in several worker processes at once,
# and each process's OpenMP threads spinning against the others' made the
# torch tests about 20 times slower on an 8-core machine.
torch.set_num_threads(1)

WEIGHTS = Path(__file__).resolve().parent.parent / "weights" \
    / "person_detector.npz"


def frame(H, W, k=3):
    """Grey and depth (metres) of dynamic frame k at H x W."""
    cam = tcfg.CameraIntrinsics(fx=W * 0.83, fy=W * 0.83, cx=(W - 1) / 2,
                                cy=(H - 1) / 2, width=W, height=H)
    rgb, depth, _, _ = synthetic.dynamic_frames(cam, k + 1)[k]
    gray = rgb.astype(np.float32) @ np.array([0.299, 0.587, 0.114],
                                             np.float32)
    return gray.astype(np.float32), depth.astype(np.float32) / 5000.0


def _jax_heat(params, gray, depth):
    """The JAX detector's heat map (the layers of `detect` up to it)."""
    x = jnp.stack([gray / 255.0, jnp.clip(depth, 0, 5.0) / 5.0], axis=-1)
    for i, (_, s) in enumerate(jpd._STAGES):
        x = jpd._conv(x, params[f"conv{i}_w"], params[f"conv{i}_b"], s)
    return jax.nn.sigmoid(jax.lax.conv_general_dilated(
        x[None], params["heat_w"], (1, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))[0, ..., 0]
        + params["heat_b"][0])


@pytest.mark.parametrize("H,W", [(128, 160), (120, 150), (96, 136)])
def test_detector_matches_jax(H, W):
    params = jpd.load_params(str(WEIGHTS))
    gray, depth = frame(H, W)
    det = tpd.load_detector(WEIGHTS, "cpu")
    heat_t, _ = det.maps(torch.from_numpy(gray), torch.from_numpy(depth))
    heat_j = np.asarray(jax.jit(_jax_heat)(params, jnp.asarray(gray),
                                           jnp.asarray(depth)))
    assert heat_t.shape == heat_j.shape == (-(-H // 16), -(-W // 16))
    np.testing.assert_allclose(heat_t.numpy(), heat_j, atol=1e-5)

    # boxes: the default threshold, and one between the 3rd and 4th peak
    # scores so that some boxes are valid on this scene
    ref = jax.jit(jpd.detect, static_argnames=("max_det", "score_thresh"))
    top = np.sort(np.asarray(ref(params, jnp.asarray(gray),
                                 jnp.asarray(depth)).scores))[::-1]
    for thresh in (0.3, float(top[2] + top[3]) / 2):
        dj = ref(params, jnp.asarray(gray), jnp.asarray(depth),
                 score_thresh=thresh)
        dt = det(torch.from_numpy(gray), torch.from_numpy(depth),
                 score_thresh=thresh)
        vj = np.asarray(dj.valid)
        np.testing.assert_array_equal(dt.valid.numpy(), vj)
        # zero-score ties may order differently: compare valid boxes only
        np.testing.assert_allclose(dt.boxes.numpy()[vj],
                                   np.asarray(dj.boxes)[vj], atol=1e-3)
        np.testing.assert_allclose(dt.scores.numpy()[vj],
                                   np.asarray(dj.scores)[vj], atol=1e-5)
    assert vj.sum() == 3


def test_detector_from_numpy_equals_loaded_weights():
    params = {k: np.asarray(v)
              for k, v in jpd.load_params(str(WEIGHTS)).items()}
    a = convert.detector_from_numpy(params)
    b = tpd.load_detector(WEIGHTS, "cpu")
    for (na, pa), (nb, pb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert na == nb
        torch.testing.assert_close(pa, pb, rtol=0, atol=0)
    assert not any(p.requires_grad for p in a.parameters())


def test_same_padding_matches_xla():
    # total pad max((ceil(n/s) - 1) * s + k - n, 0), low side total // 2
    for n, s, lo, hi in [(8, 2, 0, 1), (7, 2, 1, 1), (5, 1, 1, 1),
                         (6, 1, 1, 1), (1, 2, 1, 1)]:
        x = torch.zeros((1, 1, n, n))
        assert tpd._same_pad(x, s).shape[-1] == n + lo + hi


def test_missing_weights_raise():
    with pytest.raises(FileNotFoundError):
        tpd.load_detector(WEIGHTS.with_name("absent.npz"), "cpu")
