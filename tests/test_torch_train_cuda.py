"""Training the person detector on a CUDA card against the plain CPU path:
from `init_params()` (JAX's initial weights, drawn on the CPU), the first
5 steps on the same batches of the committed held-out labels (640x480,
batch 8). cuDNN
is asked for deterministic algorithms; the card's convolutions still sum
in another order than the CPU's, so agreement is held with stated
tolerances. Skipped without a card; on the card:

    python -m pytest --noconftest -m cuda tests/test_torch_train_cuda.py

(imports no JAX, so it runs where JAX is not installed)."""

from pathlib import Path

import numpy as np
import pytest
import torch

from supersurfel_fusion_tpu_torch.convert import to_params
from supersurfel_fusion_tpu_torch.models.person_detector import init_params
from supersurfel_fusion_tpu_torch.tools import train_person_detector as tt

EVAL_DATA = Path(__file__).resolve().parents[1] / "artifacts" \
    / "mod_boxes_eval.npz"
STEPS = 5
# the card against the CPU after 5 steps: losses (relative) and weights
LOSS_RTOL = 1e-4
PARAM_ATOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_first_steps_card_matches_cpu(cuda):
    g, d, b, c, _ = tt.load_labels(str(EVAL_DATA))
    init = init_params()
    out = {}
    for dev in ("cpu", cuda):
        trainer = tt.Trainer(init, tt.schedule_steps(len(c), 8, 30), 3e-4,
                             dev)
        labels = tt.prepare(g, d, b, c, dev)
        torch.backends.cudnn.deterministic = True
        try:
            res = tt.fit(trainer, labels, c, 8, 1, augment=True,
                         max_steps=STEPS)
        finally:
            torch.backends.cudnn.deterministic = False
        out[str(dev)] = (np.array(res["step_loss"]), to_params(trainer.det))
    (lc, pc), (lg, pg) = out["cpu"], out[str(cuda)]
    assert len(lc) == STEPS and np.all(np.isfinite(lg))
    np.testing.assert_allclose(lg, lc, rtol=LOSS_RTOL, atol=0)
    for k in pc:
        np.testing.assert_allclose(pg[k], pc[k], rtol=0, atol=PARAM_ATOL,
                                   err_msg=k)
    assert any(np.abs(pc[k] - init[k]).max() > 1e-3 for k in pc)
