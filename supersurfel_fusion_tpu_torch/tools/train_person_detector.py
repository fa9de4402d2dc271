"""Train the person detector from MOD pseudo-labels: the port's copy of the
repository's `tools/train_person_detector.py`, with the same command line.

    # 1) labels: the simple MOD path over a TUM sequence -> boxes per frame
    python -m supersurfel_fusion_tpu_torch.tools.train_person_detector \\
        --collect --dataset TUM_DIR --out labels.npz [--start 300] \\
        [--max-frames 400]
    # 2) weights: fit the heat and size heads to the boxes
    python -m supersurfel_fusion_tpu_torch.tools.train_person_detector \\
        --train --data artifacts/mod_boxes_train.npz \\
        --eval-data artifacts/mod_boxes_eval.npz --out weights.npz
    # 3) recall and precision of a checkpoint against labels
    python -m supersurfel_fusion_tpu_torch.tools.train_person_detector \\
        --eval-only --data artifacts/mod_boxes_eval.npz \\
        --weights weights/person_detector.npz [--thresh 0.2 0.3]

Everything runs on the card; `--device cpu` asks for the plain path, and
without a card and without it the script raises. The committed labels
(`artifacts/mod_boxes_train.npz`, 716 fr3/walking_halfsphere frames at
640x480, and `artifacts/mod_boxes_eval.npz`) are all `--train` and
`--eval-only` read; only `--collect` needs a TUM sequence.

What the JAX trainer does, the port does the same way, so that both draw
the same batches and follow the same loss curve:

* targets: a Gaussian heat map and a size map at stride 16, built on the
  host by the same numpy loop, uploaded once;
* loss: CenterNet's focal loss (alpha 2, beta 4, positives where the
  target heat exceeds 0.95) plus 0.1 times the L1 size loss under the
  centre mask;
* optimiser: Adam as optax builds it, `optax.adam(cosine_decay_schedule(
  lr, n_steps, alpha=0.05))`, written out on tensors in optax's order of
  operations (`torch.optim.Adam` rounds differently). `n_steps` counts
  `(N - batch + 1) // batch` steps per epoch while the loop runs
  `ceil((N - batch + 1) / batch)`, so the last steps run at `lr * alpha`
  (optax clamps the count), as in the JAX run that made the committed
  weights;
* sampling: `np.random.default_rng(0)`, class-balanced with weight 4 on
  frames that hold boxes; `--augment` flips a batch horizontally with
  probability one half (the draw is made only then);
* data: the raw uint8 grey and uint16 depth frames are uploaded once and
  the batches indexed on the device; the step converts them as the JAX
  step does (grey as f32, depth / 5000, then the network's own / 255 and
  clip(0, 5) / 5).

The package import pins full f32 for cuDNN (TF32 off), so the
convolutions train at the precision the JAX trainer used. Checkpoints are
written in the JAX layout (HWIO, with the labels' `label_*` provenance
keys), so the JAX package's `load_params` reads them.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import NamedTuple

import numpy as np
import torch
from torch.profiler import record_function

from supersurfel_fusion_tpu_torch.convert import to_params
from supersurfel_fusion_tpu_torch.device import resolve_device
from supersurfel_fusion_tpu_torch.models.person_detector import (
    _STAGES,
    PersonDetector,
    init_params,
    load_params,
)

Tensor = torch.Tensor

STRIDE = int(np.prod([s for _, s in _STAGES]))
# Adam's constants (optax.adam's defaults) and the schedule's floor
B1, B2, EPS = 0.9, 0.999, 1e-8
ALPHA = 0.05


# ---------------------------------------------------------------- labels


def collect(args) -> None:
    """Run the simple MOD path over a TUM sequence and save (grey, depth,
    boxes) per frame."""
    from supersurfel_fusion_tpu_torch.config import (
        CameraIntrinsics,
        MODConfig,
        PipelineConfig,
    )
    from supersurfel_fusion_tpu_torch.io.tum import TUMDataset
    from supersurfel_fusion_tpu_torch.pipeline import SupersurfelFusion

    cfg = PipelineConfig(cam=CameraIntrinsics.tum_fr3(),
                         mod=MODConfig(enabled=True))
    ds = TUMDataset(args.dataset)
    end = len(ds)
    if args.max_frames:
        end = min(args.start + args.max_frames, end)
    slam = SupersurfelFusion(cfg, device=args.device)

    gh, gw, cs = cfg.grid_h, cfg.grid_w, cfg.tps.cell_size
    grays, depths, all_boxes = [], [], []
    t0 = time.time()
    for i in range(args.start, end):
        f = ds.load_frame_raw(i)
        out = slam.process(f.rgb, f.depth, f.timestamp)
        if i < args.start + 2:  # MOD needs a previous frame
            continue
        static = out.static_sp.cpu().numpy().reshape(gh, gw)
        dyn = ~static
        if dyn.sum() < 4:  # no moving object this frame: a negative
            boxes = np.zeros((0, 4), np.float32)
        else:
            boxes = _boxes_from_mask(dyn, cs)
        gray = np.asarray(f.rgb[..., :3]).astype(np.float32).mean(-1)
        grays.append(gray.astype(np.uint8))
        depths.append(np.asarray(f.depth, np.uint16))
        all_boxes.append(boxes)
        if i % 50 == 0:
            print(f"frame {i}/{end}  boxes={len(boxes)}  "
                  f"({(i+1)/(time.time()-t0):.1f} fps)", flush=True)

    # ragged boxes -> fixed (N, MAXB, 4) with count
    maxb = max((len(b) for b in all_boxes), default=1) or 1
    B = np.zeros((len(all_boxes), maxb, 4), np.float32)
    C = np.zeros((len(all_boxes),), np.int32)
    for i, b in enumerate(all_boxes):
        B[i, :len(b)] = b
        C[i] = len(b)
    np.savez_compressed(args.out, gray=np.stack(grays),
                        depth=np.stack(depths), boxes=B, counts=C,
                        start=args.start, end=end,
                        dataset=os.path.basename(args.dataset.rstrip("/")))
    print(f"saved {len(all_boxes)} frames [{args.start}, {end}), "
          f"{int(C.sum())} boxes -> {args.out}")


def _boxes_from_mask(dyn: np.ndarray, cs: int) -> np.ndarray:
    """Connected components of the dynamic-cell mask -> pixel boxes."""
    gh, gw = dyn.shape
    lab = -np.ones((gh, gw), np.int32)
    nlab = 0
    for y in range(gh):
        for x in range(gw):
            if dyn[y, x] and lab[y, x] < 0:
                stack = [(y, x)]
                lab[y, x] = nlab
                while stack:
                    cy, cx = stack.pop()
                    for dy, dx in ((1, 0), (-1, 0), (0, 1), (0, -1),
                                   (1, 1), (-1, -1), (1, -1), (-1, 1)):
                        ny, nx = cy + dy, cx + dx
                        if (0 <= ny < gh and 0 <= nx < gw and dyn[ny, nx]
                                and lab[ny, nx] < 0):
                            lab[ny, nx] = nlab
                            stack.append((ny, nx))
                nlab += 1
    boxes = []
    for lb in range(nlab):
        ys, xs = np.where(lab == lb)
        if len(ys) < 6:  # too small to be a person
            continue
        boxes.append([xs.min() * cs, ys.min() * cs,
                      (xs.max() + 1) * cs, (ys.max() + 1) * cs])
    return np.asarray(boxes, np.float32).reshape(-1, 4)


def _filter_labels(boxes, counts, min_area: float, max_area: float):
    """Keep plausible person-sized label boxes: frame-area fraction within
    [min_area, max_area] and height/width aspect in [0.7, 6] (standing or
    walking people; MOD over-marking produces full-frame blobs and
    sub-superpixel fragments that teach the detector nothing). The area
    is a fraction of a 640x480 frame, whatever the labels' size."""
    if min_area <= 0.0 and max_area >= 1.0:
        return boxes, counts
    nb = np.zeros_like(boxes)
    nc = np.zeros_like(counts)
    frame_a = 640.0 * 480.0
    for i in range(len(counts)):
        k = 0
        for b in range(counts[i]):
            x0, y0, x1, y1 = boxes[i, b]
            w, h = x1 - x0, y1 - y0
            if w <= 0 or h <= 0:
                continue
            a = w * h / frame_a
            asp = h / w
            if min_area <= a <= max_area and 0.7 <= asp <= 6.0:
                nb[i, k] = boxes[i, b]
                k += 1
        nc[i] = k
    return nb, nc


def build_targets(boxes, counts, n: int, hh: int, ww: int,
                  stride: int = STRIDE):
    """Gaussian heat maps, size maps and the centre mask, (n, hh, ww),
    (n, hh, ww, 2) and (n, hh, ww) float32: the JAX trainer's loop."""
    heat_t = np.zeros((n, hh, ww), np.float32)
    size_t = np.zeros((n, hh, ww, 2), np.float32)
    size_m = np.zeros((n, hh, ww), np.float32)
    for i in range(n):
        for b in range(counts[i]):
            x0, y0, x1, y1 = boxes[i, b]
            cx, cy = (x0 + x1) / 2 / stride, (y0 + y1) / 2 / stride
            bw, bh = (x1 - x0) / stride, (y1 - y0) / stride
            if bw <= 0 or bh <= 0:
                continue
            sigma = max(1.0, 0.15 * np.sqrt(bw * bh))
            yy, xx = np.mgrid[0:hh, 0:ww]
            g = np.exp(-(((xx - cx) ** 2 + (yy - cy) ** 2)
                         / (2 * sigma * sigma)))
            heat_t[i] = np.maximum(heat_t[i], g)
            ci, cj = int(np.clip(cy, 0, hh - 1)), int(np.clip(cx, 0, ww - 1))
            size_t[i, ci, cj] = (bw, bh)
            size_m[i, ci, cj] = 1.0
    return heat_t, size_t, size_m


# --------------------------------------------------------------- training


def schedule_steps(n: int, batch: int, epochs: int) -> int:
    """The schedule's length: `epochs * max((n - batch + 1) // batch, 1)`
    (one step fewer per epoch than the loop runs where batch does not
    divide n - batch + 1)."""
    return epochs * max((n - batch + 1) // batch, 1)


def learning_rate(count: int, lr: float, n_steps: int) -> np.float32:
    """optax.cosine_decay_schedule(lr, n_steps, alpha=0.05) at `count`,
    in float32 as optax evaluates it; past n_steps it stays at lr*alpha."""
    f = np.float32
    c = f(min(count, n_steps))
    decay = f(0.5) * (f(1) + np.cos(f(np.pi) * c / f(n_steps)))
    return f(lr) * (f(1 - ALPHA) * decay + f(ALPHA))


def depth_metres(d16: Tensor) -> Tensor:
    """uint16 depth counts (stored as int16: torch indexes and converts
    int16 everywhere) -> float32 metres, as the JAX step converts."""
    return (d16.to(torch.int32) & 0xFFFF).to(torch.float32) / 5000.0


def detector_loss(logits: Tensor, size: Tensor, ht: Tensor, st: Tensor,
                  sm: Tensor) -> Tensor:
    """CenterNet focal loss (alpha 2, beta 4) plus 0.1 x the L1 size loss
    under the centre mask."""
    p = torch.sigmoid(logits)
    pos = (ht > 0.95).to(torch.float32)
    l_pos = -pos * ((1 - p) ** 2) * torch.log(torch.clamp(p, min=1e-6))
    l_neg = (-(1 - pos) * ((1 - ht) ** 4) * (p ** 2)
             * torch.log(torch.clamp(1 - p, min=1e-6)))
    n_pos = torch.clamp(pos.sum(), min=1.0)
    l_heat = (l_pos.sum() + l_neg.sum()) / n_pos
    l_size = ((size - st).abs().sum(-1) * sm).sum() / torch.clamp(
        sm.sum(), min=1.0)
    return l_heat + 0.1 * l_size


class Trainer:
    """The detector, its Adam moments and the step count on one device:
    the JAX trainer's jitted step."""

    def __init__(self, params: dict, n_steps: int, lr: float,
                 device: str | torch.device = "cuda"):
        self.det = PersonDetector.from_params(params).to(
            resolve_device(device))
        self.det.requires_grad_(True)
        self.params = list(self.det.parameters())
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0
        self.n_steps, self.lr = n_steps, lr

    def step(self, g_u8: Tensor, d16: Tensor, ht: Tensor, st: Tensor,
             sm: Tensor) -> Tensor:
        """One step on a batch: returns the loss before the update (a 0-d
        tensor on the device; nothing waits for it)."""
        with record_function("ssf.train_loss"):
            logits, size = self.det.forward_maps(g_u8.to(torch.float32),
                                                 depth_metres(d16))
            loss = detector_loss(logits, size, ht, st, sm)
        with record_function("ssf.train_grad"):
            grads = torch.autograd.grad(loss, self.params)
        with record_function("ssf.train_adam"):
            self.update(grads)
        return loss.detach()

    @torch.no_grad()
    def update(self, grads) -> None:
        """optax.adam's update, in its order: mu = (1-b1) g + b1 mu, nu
        likewise with g*g, bias corrections at count + 1, u = mu_hat /
        (sqrt(nu_hat) + eps), p += u * -lr(count)."""
        t = self.count + 1
        bc1 = float(np.float32(1.0 - B1 ** t))
        bc2 = float(np.float32(1.0 - B2 ** t))
        lr = float(learning_rate(self.count, self.lr, self.n_steps))
        torch._foreach_mul_(self.mu, B1)
        torch._foreach_add_(self.mu, torch._foreach_mul(grads, 1 - B1))
        sq = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(self.nu, B2)
        torch._foreach_add_(self.nu, torch._foreach_mul(sq, 1 - B2))
        den = torch._foreach_sqrt(torch._foreach_div(self.nu, bc2))
        torch._foreach_add_(den, EPS)
        upd = torch._foreach_div(torch._foreach_div(self.mu, bc1), den)
        torch._foreach_mul_(upd, -lr)
        torch._foreach_add_(self.params, upd)
        self.count = t


class LabelSet(NamedTuple):
    """A label file's frames and targets on one device."""

    gray: Tensor    # (N, H, W) uint8
    depth: Tensor   # (N, H, W) int16 holding the uint16 counts
    heat: Tensor    # (N, hh, ww)
    size: Tensor    # (N, hh, ww, 2)
    mask: Tensor    # (N, hh, ww)

    def batch(self, idx: Tensor, flip: bool = False):
        b = [a.index_select(0, idx) for a in self]
        if flip:
            b = [torch.flip(a, dims=[2]) for a in b]
        return b


def epochs_plan(counts: np.ndarray, batch: int, epochs: int,
                augment: bool):
    """The JAX trainer's draws from `np.random.default_rng(0)`, epoch by
    epoch: a class-balanced order of the frames (with replacement, weight
    4 on frames that hold boxes; they are rare, and the focal loss's
    positives rarer still), then each batch's flip, drawn only under
    `augment`. Yields (order (N,) int64, [(start, flip), ...])."""
    n = len(counts)
    rng = np.random.default_rng(0)
    w = np.where(counts > 0, 4.0, 1.0)
    w = w / w.sum()
    for _ in range(epochs):
        order = rng.choice(n, size=n, replace=True, p=w)
        # horizontal flips: the labels come from one camera sweep, so
        # people appear at biased image positions
        yield order, [(k, bool(augment and rng.random() < 0.5))
                      for k in range(0, n - batch + 1, batch)]


def fit(trainer: Trainer, labels: LabelSet, counts: np.ndarray, batch: int,
        epochs: int, augment: bool, timing: bool = False,
        max_steps: int | None = None) -> dict:
    """Train `trainer` on `labels` for `epochs` (or its first `max_steps`
    steps). Each epoch's order goes to the device once and the batches
    are indexed there; the losses are read once per epoch. With `timing`,
    CUDA events time every step (nothing waits inside an epoch).

    Returns {"epoch_loss", "lr" (every step's), "step_loss", "step_ms"}."""
    dev = labels.gray.device
    epoch_loss, step_loss, lrs, step_ms = [], [], [], []
    for epoch, (order, plan) in enumerate(
            epochs_plan(counts, batch, epochs, augment)):
        order = torch.from_numpy(order).to(dev)
        losses, events = [], []
        if timing:
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()
        for k, flip in plan[:max_steps]:
            lrs.append(float(learning_rate(trainer.count, trainer.lr,
                                           trainer.n_steps)))
            with record_function("ssf.train_batch"):
                b = labels.batch(order[k:k + batch], flip)
            losses.append(trainer.step(*b))
            if timing:
                events.append(torch.cuda.Event(enable_timing=True))
                events[-1].record()
        host = torch.stack(losses).cpu().numpy()
        step_loss += host.tolist()
        epoch_loss.append(float(np.mean(host)))
        step_ms += [a.elapsed_time(b) for a, b in zip(events, events[1:])]
        if max_steps is not None:
            break
        print(f"epoch {epoch}: loss {epoch_loss[-1]:.4f}", flush=True)
    return {"epoch_loss": epoch_loss, "step_loss": step_loss, "lr": lrs,
            "step_ms": step_ms}


def load_labels(path: str, min_area: float = 0.0, max_area: float = 1.0):
    """(grey uint8, depth uint16, boxes, counts, provenance) of a label
    file, the boxes through `_filter_labels`."""
    with np.load(path) as data:
        boxes, counts = _filter_labels(data["boxes"], data["counts"],
                                       min_area, max_area)
        meta = {f"label_{k}": data[k] for k in ("start", "end", "dataset")
                if k in data}
        return data["gray"], data["depth"], boxes, counts, meta


def prepare(gray_u8, depth_u16, boxes, counts, device) -> LabelSet:
    """A label file's frames (the uint16 depth as int16) and targets on
    `device`."""
    n, h, w = gray_u8.shape
    dev = torch.device(device)
    targets = build_targets(boxes, counts, n, h // STRIDE, w // STRIDE)
    return LabelSet(torch.from_numpy(gray_u8).to(dev),
                    torch.from_numpy(depth_u16.view(np.int16)).to(dev),
                    *(torch.from_numpy(t).to(dev) for t in targets))


def train(args, params: dict | None = None, timing: bool = False) -> dict:
    """Train from `args.data` (defaults: 30 epochs, batch 8, lr 3e-4),
    write `args.out`, evaluate on the training and `args.eval_data`
    labels. `params` is the starting parameter dict (numpy, HWIO); the
    default is `init_params()`.

    Returns `fit`'s dict with "n_steps", "steps_per_epoch", "train_s"
    (the epochs' wall time), "trainer" and "eval" (BoxScores)."""
    dev = resolve_device(args.device)
    gray_u8, depth_u16, boxes, counts, meta = load_labels(
        args.data, args.min_area, args.max_area)
    print(f"labels after area/aspect filter: {int(counts.sum())} boxes in "
          f"{int((counts > 0).sum())}/{len(counts)} frames", flush=True)
    N, H, W = gray_u8.shape
    print(f"{N} frames, heat {H // STRIDE}x{W // STRIDE}, stride {STRIDE}")
    labels = prepare(gray_u8, depth_u16, boxes, counts, dev)

    n_steps = schedule_steps(N, args.batch, args.epochs)
    trainer = Trainer(init_params() if params is None else params, n_steps,
                      args.lr, dev)
    t0 = time.time()
    res = fit(trainer, labels, counts, args.batch, args.epochs, args.augment,
              timing=timing)
    res.update(train_s=time.time() - t0, n_steps=n_steps, trainer=trainer,
               steps_per_epoch=len(range(0, N - args.batch + 1, args.batch)))

    params_out = to_params(trainer.det)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    np.savez(args.out, **params_out, **{k: np.asarray(v)
                                        for k, v in meta.items()})
    print(f"saved weights -> {args.out} (label provenance: {meta})")

    det = PersonDetector.from_params(params_out).to(dev)
    res["eval"] = {"train": _eval_boxes(
        det, "train-set", gray_u8, depth_u16, boxes, counts,
        stride_n=max(N // 50, 1))}
    if args.eval_data:
        eg, ed, eb, ec, _ = load_labels(args.eval_data, args.min_area,
                                        args.max_area)
        res["eval"]["held_out"] = _eval_boxes(
            det, f"HELD-OUT ({os.path.basename(args.eval_data)})",
            eg, ed, eb, ec)
    return res


# ------------------------------------------------------------ evaluation


class BoxScore(NamedTuple):
    recall: float
    precision: float
    hits: int       # label boxes hit by a detection (IoU > 0.3)
    total: int      # label boxes
    n_det: int      # valid detections
    n_match: int    # detections that hit a label box


def _eval_boxes(det: PersonDetector, name, g_u8, d_u16, bxs, cts,
                stride_n=1, thresh=0.3) -> BoxScore:
    """Box recall and precision at IoU 0.3 of the detector against the
    (pseudo-)labels: for each label box the first detection that hits it
    counts, and each detection matches once."""
    dev = next(det.parameters()).device
    hits = tot = ndet = nmatch = 0
    for i in range(0, len(g_u8), stride_n):
        out = det(torch.from_numpy(g_u8[i].astype(np.float32)).to(dev),
                  torch.from_numpy(d_u16[i].astype(np.float32)
                                   / 5000.0).to(dev),
                  score_thresh=thresh)
        db = out.boxes.cpu().numpy()[out.valid.cpu().numpy()]
        ndet += len(db)
        used = set()
        for b in range(cts[i]):
            tot += 1
            x0, y0, x1, y1 = bxs[i, b]
            for k, d0 in enumerate(db):
                ix = max(0, min(x1, d0[2]) - max(x0, d0[0]))
                iy = max(0, min(y1, d0[3]) - max(y0, d0[1]))
                inter = ix * iy
                a = ((x1 - x0) * (y1 - y0)
                     + (d0[2] - d0[0]) * (d0[3] - d0[1]))
                if inter / max(a - inter, 1e-9) > 0.3:
                    hits += 1
                    if k not in used:
                        used.add(k)
                        nmatch += 1
                    break
    rec = hits / max(tot, 1)
    prec = nmatch / max(ndet, 1)
    print(f"{name}: recall@IoU0.3 {hits}/{tot} = {rec:.2f}  "
          f"precision {nmatch}/{ndet} = {prec:.2f}", flush=True)
    return BoxScore(rec, prec, hits, tot, ndet, nmatch)


def eval_only(args) -> list:
    det = PersonDetector.from_params(load_params(args.weights)).to(
        resolve_device(args.device))
    g, d, b, c, _ = load_labels(args.data, args.min_area, args.max_area)
    return [_eval_boxes(det, f"{os.path.basename(args.weights)} "
                        f"thresh={th} vs {os.path.basename(args.data)}",
                        g, d, b, c, thresh=th)
            for th in args.thresh]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--collect", action="store_true")
    ap.add_argument("--train", action="store_true")
    ap.add_argument("--dataset", default=None,
                    help="--collect: the TUM sequence directory")
    ap.add_argument("--data", default="mod_boxes.npz")
    ap.add_argument("--eval-data", default=None,
                    help="held-out labels npz for recall/precision")
    ap.add_argument("--out", default=None)
    ap.add_argument("--start", type=int, default=0,
                    help="--collect: first frame (use a range DISJOINT from "
                         "the scored benchmark window)")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--min-area", type=float, default=0.0,
                    help="drop label boxes below this frame-area fraction")
    ap.add_argument("--max-area", type=float, default=1.0,
                    help="drop label boxes above this frame-area fraction "
                         "(over-marked MOD scenes produce full-frame blobs)")
    ap.add_argument("--eval-only", action="store_true",
                    help="evaluate --weights against --data labels")
    ap.add_argument("--weights", default="weights/person_detector.npz")
    ap.add_argument("--thresh", type=float, nargs="*", default=[0.3],
                    help="--eval-only: score thresholds to sweep")
    ap.add_argument("--augment", action="store_true",
                    help="--train: random horizontal flips")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain path")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.collect:
        if not args.dataset:
            print("--collect needs --dataset (a TUM sequence directory)")
            return 1
        args.out = args.out or "mod_boxes.npz"
        collect(args)
        return 0
    if args.eval_only:
        eval_only(args)
        return 0
    if args.train:
        args.out = args.out or "person_detector.npz"
        train(args)
        return 0
    print("specify --collect, --train or --eval-only")
    return 1


if __name__ == "__main__":
    sys.exit(main())
