"""Loop closure on a CUDA card against the plain CPU path: the fern codes,
the deformation graph's Gauss-Newton solve, one closure frame of the
revisit clip, and checkpoints moved between the devices. Skipped without a
card; on the card:

    python -m pytest --noconftest -m cuda tests/test_torch_lc_cuda.py

(imports no JAX, so it runs where JAX is not installed)."""

import numpy as np
import pytest
import torch

from supersurfel_fusion_tpu_torch import convert, synthetic
from supersurfel_fusion_tpu_torch.config import FernsConfig, PipelineConfig
from supersurfel_fusion_tpu_torch.io import export
from supersurfel_fusion_tpu_torch.ops import deformation as defo
from supersurfel_fusion_tpu_torch.ops import ferns, loop_closure
from supersurfel_fusion_tpu_torch.pipeline import process_frame
from supersurfel_fusion_tpu_torch.pipeline import init_state
from supersurfel_fusion_tpu_torch.tools.profile_frame import lc_config


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _to(x, dev):
    """Tensors, and NamedTuples or tuples of them, on `dev`."""
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, tuple):
        items = [_to(v, dev) for v in x]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    return x


def state_to(state, device):
    """A `SLAMState` copied to `device` (through its numpy form)."""
    return convert.state_from_numpy(convert.state_to_numpy(state), device,
                                    detector=state.detector)


@pytest.mark.cuda
def test_fern_codes_card_equal_cpu(cuda):
    cfg = PipelineConfig()
    fc = FernsConfig()
    cpu_t = ferns.make_fern_table(fc, 640, 480, 5.0, "cpu")
    card_t = ferns.make_fern_table(fc, 640, 480, 5.0, cuda)
    for rgb, depth, _ in synthetic.revisit_frames(cfg.cam)[::4]:
        r = torch.from_numpy(rgb).float()
        d = torch.from_numpy(depth.astype(np.float32)) * cfg.depth_scale
        c = ferns.compute_codes(r, d, *cpu_t, fc.pyramid_level)
        g = ferns.compute_codes(r.to(cuda), d.to(cuda), *card_t,
                                fc.pyramid_level)
        assert torch.equal(g.cpu(), c)


def _corridor(device):
    """tests/test_deformation.py's drifted corridor."""
    n = 400
    pos = np.zeros((n, 3), np.float32)
    pos[:, 0] = np.linspace(0, 4, n)
    st = np.arange(n, dtype=np.int32)
    idx = np.concatenate([np.arange(16), n - 16 + np.arange(16)])
    src, tgt = pos[idx], pos[idx].copy()
    tgt[16:, 1] += 0.2
    T = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    g = defo.build_graph(T(pos), T(st),
                         torch.tensor(n, dtype=torch.int32, device=device))
    ok = torch.ones(32, dtype=torch.bool, device=device)
    b = defo.bind_vertices(g, T(src), T(st[idx]), ok)
    return g, b, T(src), T(tgt), ok


@pytest.mark.cuda
def test_optimise_card_matches_cpu(cuda):
    """Same inputs, same Gauss-Newton steps; cuBLAS and cuSOLVER sum in
    another order than the CPU: rotations and translations within 1e-5,
    the error within 1e-3 relative and the mean constraint error within
    1e-7 m."""
    rc = defo.optimise(*_corridor("cpu"), n_iters=5)
    rg = defo.optimise(*_corridor(cuda), n_iters=5)
    for a, b, tol in zip(rg, rc, (1e-5, 1e-5)):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), atol=tol)
    np.testing.assert_allclose(float(rg[2]), float(rc[2]), rtol=1e-3)
    np.testing.assert_allclose(float(rg[3]), float(rc[3]), atol=1e-7)
    assert float(rg[3]) < 0.02


@pytest.mark.cuda
def test_closure_frame_card_matches_cpu(cuda, monkeypatch):
    """The revisit clip at 640x480 on the card up to the frame the gate
    fires on; that frame on the card and, from the card's state moved
    there, on the CPU: `accepted` equal, poses within 2 mm, keyframe poses
    within 1 mm. The branch itself on both devices from the card's inputs:
    the deformed model's live positions in the scene (within 10 m of the
    origin) within 1 cm everywhere and 1 mm on 99% of them. Surfels the
    known fusion fault threw far off the scene (ROADMAP Queue 3) are not
    compared: a node rotation's rounding moves them by metres."""
    cfg = lc_config()
    state = init_state(cfg, cuda)
    for rgb, depth, _ in synthetic.revisit_frames(cfg.cam):
        before = state
        state, out = process_frame(state, rgb, depth, cfg)
        if out.lc_gate:
            break
    assert out.lc_gate and bool(out.lc_accepted)
    cpu_state, cpu_out = process_frame(state_to(before, "cpu"), rgb, depth,
                                       cfg)
    assert cpu_out.lc_gate and bool(cpu_out.lc_accepted)
    dt = (out.pose.t.cpu() - cpu_out.pose.t).abs().max()
    assert float(dt) < 2e-3, float(dt)
    k = int(state.kf_store.db.count)
    np.testing.assert_allclose(state.kf_store.db.poses_t[:k].cpu().numpy(),
                               cpu_state.kf_store.db.poses_t[:k].numpy(),
                               atol=1e-3)

    args = []
    orig = loop_closure.close_global_loop

    def keep(*a, **kw):
        args.append(a)
        return orig(*a, **kw)

    monkeypatch.setattr(loop_closure, "close_global_loop", keep)
    process_frame(before, rgb, depth, cfg)
    card = orig(*args[0])
    cpu = orig(*_to(args[0], "cpu"))
    assert bool(card.accepted) and bool(cpu.accepted)
    n = int(before.model.nb_supersurfels)
    p0 = before.model.surfels.positions[:n].cpu()
    live = (before.model.surfels.confidences[:n] > 0).cpu()
    scene = live & (p0.norm(dim=-1) < 10.0)
    d = (cpu.model.positions[:n]
         - card.model.positions[:n].cpu()).norm(dim=-1)[scene]
    assert float(d.max()) < 1e-2
    assert float(d.quantile(0.99)) < 1e-3
    assert int(scene.sum()) > 0.5 * int(live.sum())


@pytest.mark.cuda
def test_checkpoint_moves_between_devices(cuda, tmp_path):
    cfg = lc_config()
    clip = synthetic.revisit_frames(cfg.cam)[:2]
    state = init_state(cfg, cuda)
    state, _ = process_frame(state, *clip[0][:2], cfg)
    p = export.save_checkpoint(str(tmp_path / "card.pt"), state)
    on_cpu = export.load_checkpoint(p, device="cpu")
    back = export.load_checkpoint(
        export.save_checkpoint(str(tmp_path / "cpu.pt"), on_cpu), cuda)
    a, b = convert.state_to_numpy(state), convert.state_to_numpy(back)
    assert a.keys() == b.keys()
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    assert on_cpu.stamp.device.type == "cpu"
    assert back.kf_store.sf_pos.device.type == "cuda"
