"""The TPS iteration kernels' plain versions (`ops/tps_cuda.py`) vs the JAX
package's Pallas kernel in interpret mode, on the CPU. The CUDA kernels
themselves are held against these plain versions in
`tests/test_torch_tps_cuda.py` (needs a card) and `chip_smoke.py`."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supersurfel_fusion_tpu.config import TPSConfig as JTPSConfig
from supersurfel_fusion_tpu.ops import tps_pallas
from supersurfel_fusion_tpu.ops.depth import depth_to_disp
from supersurfel_fusion_tpu_torch.config import TPSConfig
from supersurfel_fusion_tpu_torch.ops import tps as ttps
from supersurfel_fusion_tpu_torch.ops import tps_cuda

from test_torch_depth_tps import scene


def test_reference_matches_pallas_interpret():
    """Thresholds of tests/test_tps_pallas.py: the Pallas kernel keeps its
    stat image in bf16, so a few boundary pixels and plane fits differ."""
    H, W = 64, 128
    rgb, depth = scene()
    disp = np.array(depth_to_disp(jnp.asarray(depth)))
    rp = tps_pallas.segment(jnp.asarray(rgb), jnp.asarray(disp),
                            JTPSConfig(nb_iters=2), interpret=True)
    rt = tps_cuda.segment(torch.from_numpy(rgb), torch.from_numpy(disp),
                          TPSConfig(nb_iters=2))
    lp, lt = np.asarray(rp.labels), rt.labels.numpy()
    assert (lp == lt).mean() > 0.97
    assert float(rt.stats.size.sum()) == H * W
    np.testing.assert_allclose(rt.inliers.float().mean().item(),
                               np.asarray(rp.inliers).mean(), atol=0.02)
    thp, tht = np.asarray(rp.stats.theta), rt.stats.theta.numpy()
    assert np.isfinite(tht[..., 2]).mean() > 0.9
    both = np.isfinite(thp[..., 2]) & np.isfinite(tht[..., 2])
    assert np.nanmedian(np.abs(thp[both] - tht[both])) < 1e-3


def test_reference_matches_plain_segment():
    """The iteration loop on the kernels' plain versions is the plain
    segmentation with the once-per-iteration merge."""
    rgb, depth = scene(seed=5)
    disp = torch.from_numpy(np.array(depth_to_disp(jnp.asarray(depth))))
    cfg = TPSConfig(nb_iters=4)
    a = tps_cuda.segment(torch.from_numpy(rgb), disp, cfg)
    b = ttps.segment(torch.from_numpy(rgb), disp, cfg)
    assert (a.labels == b.labels).float().mean().item() >= 0.99
    assert (a.inliers == b.inliers).float().mean().item() >= 0.99


def test_cpu_wrappers_count_no_launches():
    rgb, depth = scene()
    disp = torch.from_numpy(np.array(depth_to_disp(jnp.asarray(depth))))
    tps_cuda.reset_launch_counts()
    tps_cuda.segment(torch.from_numpy(rgb), disp, TPSConfig(nb_iters=2))
    assert tps_cuda.launch_counts == {"tps_phase": 0, "tps_merge": 0}
    with pytest.raises(ValueError):
        tps_cuda.segment(torch.from_numpy(rgb), disp,
                         TPSConfig(merge_every_phase=True))
