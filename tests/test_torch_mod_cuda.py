"""The MOD path on a CUDA card against the plain CPU path: the person
detector and `detect_motion` (atomic float scatter-adds, cuDNN
convolutions and the card's SVD order sums differently, so agreement is
held with stated tolerances). Skipped without a card; on the card:

    python -m pytest --noconftest -m cuda tests/test_torch_mod_cuda.py

(imports no JAX, so it runs where JAX is not installed)."""

import numpy as np
import pytest
import torch

from supersurfel_fusion_tpu_torch import synthetic
from supersurfel_fusion_tpu_torch.models.person_detector import load_detector
from supersurfel_fusion_tpu_torch.ops import motion
from supersurfel_fusion_tpu_torch.ops.features import detect_and_describe
from supersurfel_fusion_tpu_torch.pipeline import front_end
from supersurfel_fusion_tpu_torch.tools.profile_frame import mod_config
from supersurfel_fusion_tpu_torch.utils.color import rgb_to_gray

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _to(nt, dev):
    """A NamedTuple of tensors (nested ones too) on `dev`."""
    return type(nt)(*(_to(v, dev) if isinstance(v, tuple) else v.to(dev)
                      for v in nt))


@pytest.mark.cuda
def test_detector_card_matches_cpu(cuda):
    cfg = mod_config()
    rgb, depth, _, _ = synthetic.dynamic_frames(cfg.cam, 4)[3]
    gray = rgb_to_gray(torch.from_numpy(rgb).float())
    d = torch.from_numpy(depth.astype(np.float32)) * cfg.depth_scale
    cpu = load_detector(cfg.mod.weights_path, "cpu")
    card = load_detector(cfg.mod.weights_path, cuda)
    hc, _ = cpu.maps(gray, d)
    hg, _ = card.maps(gray.to(cuda), d.to(cuda))
    assert (hg.cpu() - hc).abs().max().item() <= 1e-5
    # a threshold between the 3rd and 4th peak makes some boxes valid
    top = torch.sort(cpu(gray, d).scores, descending=True).values
    thresh = float(top[2] + top[3]) / 2
    dc = cpu(gray, d, score_thresh=thresh)
    dg = card(gray.to(cuda), d.to(cuda), score_thresh=thresh)
    assert torch.equal(dg.valid.cpu(), dc.valid)
    v = dc.valid
    torch.testing.assert_close(dg.boxes.cpu()[v], dc.boxes[v], rtol=0,
                               atol=1e-2)


@pytest.mark.cuda
def test_detect_motion_card_matches_cpu(cuda):
    """Two consecutive dynamic frames at 640x480; the same front end,
    keypoints and previous context go to both devices."""
    cfg = mod_config()
    clip = synthetic.dynamic_frames(cfg.cam, 6)
    det_cpu = load_detector(cfg.mod.weights_path, "cpu")
    prev = None
    outs = {}
    for k in (4, 5):
        rgb = torch.from_numpy(clip[k][0]).float()
        depth = torch.from_numpy(clip[k][1].astype(np.float32)) \
            * cfg.depth_scale
        fe = front_end(rgb, depth, cfg, torch.tensor(k, dtype=torch.int32))
        gray = rgb_to_gray(rgb)
        kp = detect_and_describe(gray, cfg.vo)
        if k == 4:
            prev = motion.init_prev(480, 640, kp.capacity, device="cpu")
            _, _, prev = motion.detect_motion(
                gray, fe.fdepth, prev, kp, fe.frame, fe.tps, cfg.cam,
                cfg.tps, cfg.mod, detector=det_cpu)
            continue
        args = (gray, fe.fdepth, prev, kp, fe.frame, fe.tps)
        outs["cpu"] = motion.detect_motion(*args, cfg.cam, cfg.tps, cfg.mod,
                                           detector=det_cpu)
        outs["card"] = motion.detect_motion(
            *(_to(a, cuda) if isinstance(a, tuple) else a.to(cuda)
              for a in args), cfg.cam, cfg.tps, cfg.mod,
            detector=load_detector(cfg.mod.weights_path, cuda))
    (sc, kc, _), (sg, kg, _) = outs["cpu"], outs["card"]
    assert (~sc).sum() > 0
    assert (sg.cpu() == sc).float().mean().item() >= 0.99
    assert (kg.cpu() == kc).float().mean().item() >= 0.99
