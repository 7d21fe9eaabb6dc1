"""The training loop: the SuperGradients-Trainer equivalent, on one card.

Counterpart of ``head_detector_tpu/train/runner.py``: build the
training-layout model, optionally warm-start it by key matching, resume from
the latest checkpoint, run epochs of train steps fed by a thread-pool
loader, validate on the EMA weights after every epoch (post-prediction
decode -> matched metrics) and save a checkpoint with the metrics.
TensorBoard logging and the extreme-batch panels are not ported.
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import queue
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch.func import functional_call

from head_detector_tpu_torch.device import exact_float32, resolve_device
from head_detector_tpu_torch.flame import FlameModel
from head_detector_tpu_torch.models import build_model, get_arch, init_model
from head_detector_tpu_torch.models.presets import ArchCfg
from head_detector_tpu_torch.post_prediction import YoloHeadsPostPredictionCallback
from head_detector_tpu_torch.train.checkpoint import CheckpointManager, restore_key_matching
from head_detector_tpu_torch.train.dataset import collate_samples
from head_detector_tpu_torch.train.loss import LossConfig
from head_detector_tpu_torch.train.mesh_sample import MeshEstimationSample
from head_detector_tpu_torch.train.trainer import (
    TrainConfig,
    TrainState,
    images_to_device,
    make_train_step,
)
from head_detector_tpu_torch.weights import load_variables


@dataclasses.dataclass
class RunConfig:
    """Top-level run configuration (knob names follow the reference recipes)."""

    arch: object = "yolo_heads_l"  # preset name or an ArchCfg instance
    image_size: int = 640
    batch_size: int = 8
    max_epochs: int = 50
    steps_per_epoch: Optional[int] = None  # None = full dataset
    max_gt_boxes: int = 30
    num_workers: int = 4
    mixed_precision: bool = True  # bfloat16 compute, float32 master weights
    ckpt_dir: str = "checkpoints/run"
    resume: bool = False
    pretrained_weights: Optional[str] = None  # msgpack path, key_matching load
    metric_to_watch: str = "KeypointsNME"
    greater_metric_to_watch_is_better: bool = False
    ckpt_max_to_keep: int = 10
    log_every: int = 50
    # exit the epoch loop after this many epochs per invocation (chunked
    # campaigns re-invoke with resume=True); None = run to max_epochs
    epochs_per_run: Optional[int] = None
    loss: LossConfig = dataclasses.field(default_factory=LossConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)


class _Prefetcher:
    """Thread-pool sample loader + collate (the DataLoader-worker analogue).
    A loader error is raised in the consumer; a consumer that stops early
    stops the producer."""

    def __init__(self, dataset, batch_size: int, max_boxes: int, num_workers: int = 4,
                 seed: int = 0, drop_last: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.max_boxes = max_boxes
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.drop_last = drop_last

    def __len__(self):
        """Number of batches one pass yields (tail included iff not drop_last)."""
        n = len(self.dataset) // self.batch_size
        if not self.drop_last and len(self.dataset) % self.batch_size:
            n += 1
        return n

    def __iter__(self):
        order = np.random.RandomState(self.seed).permutation(len(self.dataset))
        q: "queue.Queue" = queue.Queue(maxsize=4)
        stop = threading.Event()  # set by the consumer on early break

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.5)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                with cf.ThreadPoolExecutor(self.num_workers) as pool:
                    for b in range(len(self)):
                        idxs = order[b * self.batch_size:(b + 1) * self.batch_size]
                        samples = list(pool.map(self.dataset.__getitem__, idxs))
                        if not put(collate_samples(samples, self.max_boxes)):
                            return
            except BaseException as e:  # surface loader errors, don't hang
                put(e)
                return
            put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            while not q.empty():
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            t.join()


class Trainer:
    """build -> (optional key-matching restore) -> (optional resume) ->
    epochs of train steps -> validation on the EMA weights -> checkpoint.

    ``timings`` holds one record per epoch (host seconds of the train loop,
    synchronised at its end, of validation and of the save, and the images
    seen); ``step_components`` the loss components of every step, as device
    tensors (reading them waits for the step)."""

    def __init__(self, cfg: RunConfig, train_dataset, val_dataset=None,
                 metrics_factory: Optional[Callable] = None, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.train_dataset = train_dataset
        self.val_dataset = val_dataset
        self.flame = FlameModel.from_assets(device=self.device)

        dtype = torch.bfloat16 if cfg.mixed_precision else torch.float32
        self.arch = cfg.arch if isinstance(cfg.arch, ArchCfg) else get_arch(cfg.arch)
        self.model = build_model(self.arch, dtype=dtype, deploy=False).to(self.device)
        init_model(self.model, torch.Generator().manual_seed(0),
                   (cfg.image_size, cfg.image_size))
        self.restored_leaves = None
        if cfg.pretrained_weights:
            merged, matched, total = restore_key_matching(
                self.model.state_dict(), load_variables(cfg.pretrained_weights))
            self.model.load_state_dict(merged, strict=True)
            self.restored_leaves = (matched, total)
            print(f"[trainer] key_matching restore: {matched}/{total} leaves")

        data_batches = max(len(train_dataset) // cfg.batch_size, 1)
        steps_per_epoch = cfg.steps_per_epoch or data_batches
        if steps_per_epoch > data_batches:
            # resume arithmetic (step // steps_per_epoch) and the cosine
            # length both assume every epoch runs exactly steps_per_epoch
            print(f"[trainer] steps_per_epoch {steps_per_epoch} exceeds the "
                  f"dataset's {data_batches} batches; clamping")
            steps_per_epoch = data_batches
        self.steps_per_epoch = steps_per_epoch
        self.train_cfg = dataclasses.replace(cfg.train,
                                             max_steps=steps_per_epoch * cfg.max_epochs)
        self.state = TrainState(self.model, self.train_cfg)
        self.step_fn = make_train_step(self.model, self.flame, cfg.loss, self.train_cfg)
        self.ckpt = CheckpointManager(
            cfg.ckpt_dir,
            metric_to_watch=cfg.metric_to_watch,
            greater_is_better=cfg.greater_metric_to_watch_is_better,
            max_to_keep=cfg.ckpt_max_to_keep,
        )
        self.metrics_factory = metrics_factory or self._default_metrics
        self.history: List[Dict[str, float]] = []
        self.timings: List[Dict[str, float]] = []
        self.step_components: List[Dict[str, torch.Tensor]] = []

        if cfg.resume:
            latest = self.ckpt.latest_step()
            if latest is not None:
                self.state.load_state_dict(self.ckpt.restore(latest))
                print(f"[trainer] resumed from step {self.state.step}")

    # ------------------------------------------------------------------ #
    def _default_metrics(self):
        from head_detector_tpu_torch.metrics import (
            KeypointsFailureRate,
            KeypointsNME,
            RPYError,
        )

        callback = YoloHeadsPostPredictionCallback(
            flame_model=self.flame,
            confidence_threshold=0.5,
            nms_iou_threshold=0.7,
            pre_nms_max_predictions=300,
            post_nms_max_predictions=30,
        )
        return {
            "KeypointsNME": KeypointsNME(callback, indexes_subset="head"),
            "KeypointsFailureRate": KeypointsFailureRate(callback, indexes_subset="head"),
            "RPYError": RPYError(callback),
        }

    @torch.no_grad()
    def predict(self, images, ema: bool = True):
        """Eval-mode decoded predictions of uint8 NHWC ``images`` with the EMA
        parameters (or the current ones) and the current BatchNorm statistics."""
        self.model.eval()
        params = self.state.ema if ema and self.train_cfg.ema else self.state.params()
        with exact_float32():
            decoded, _ = functional_call(
                self.model, {**params, **self.state.batch_stats()},
                (images_to_device(images, self.device),))
        return decoded

    def validate(self) -> Dict[str, float]:
        if self.val_dataset is None:
            return {}
        metrics = self.metrics_factory()
        loader = _Prefetcher(self.val_dataset, self.cfg.batch_size, self.cfg.max_gt_boxes,
                             self.cfg.num_workers, seed=0)
        for images, targets in loader:
            decoded = self.predict(images)
            gt_samples = _targets_to_samples(images, targets)
            for m in metrics.values():
                m.update(decoded, gt_samples)
        out: Dict[str, float] = {}
        for name, m in metrics.items():
            value = m.compute()
            if isinstance(value, dict):
                out.update(value)
                if name == "RPYError":
                    out[name] = value.get("RPY_mean", 0.0)
            else:
                out[name] = float(value)
        return out

    def _synchronize(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def train(self) -> Dict[str, float]:
        cfg = self.cfg
        last_metrics: Dict[str, float] = {}
        start_epoch = self.state.step // self.steps_per_epoch
        for epoch in range(start_epoch, cfg.max_epochs):
            if cfg.epochs_per_run and epoch - start_epoch >= cfg.epochs_per_run:
                print(f"[trainer] epochs_per_run={cfg.epochs_per_run} reached "
                      f"at epoch {epoch}; exiting for chunk restart")
                break
            if hasattr(self.train_dataset, "set_epoch"):
                self.train_dataset.set_epoch(epoch)
            loader = _Prefetcher(self.train_dataset, cfg.batch_size, cfg.max_gt_boxes,
                                 cfg.num_workers, seed=epoch)
            t0 = time.perf_counter()
            seen = 0
            for bi, (images, targets) in enumerate(loader):
                _, comps = self.step_fn(self.state, images, targets)
                self.step_components.append(comps)
                seen += images.shape[0]
                if (bi + 1) % cfg.log_every == 0:
                    c = {k: float(v) for k, v in comps.items()}
                    ips = seen / (time.perf_counter() - t0)
                    print(f"[epoch {epoch} step {self.state.step}] "
                          f"loss={c['loss']:.4f} cls={c['loss_cls']:.4f} "
                          f"iou={c['loss_iou']:.4f} pose={c['loss_pose_reg']:.4f} "
                          f"verts={c['loss_3d_vertices']:.4f} ({ips:.1f} img/s)")
                if cfg.steps_per_epoch and bi + 1 >= cfg.steps_per_epoch:
                    break
            self._synchronize()
            t1 = time.perf_counter()
            last_metrics = self.validate()
            t2 = time.perf_counter()
            if last_metrics:
                print(f"[epoch {epoch}] val: {last_metrics}")
            self.history.append(dict(last_metrics))
            self.ckpt.save(self.state.step, self.state.state_dict(), metrics=last_metrics)
            self.timings.append({"epoch": epoch, "train_s": t1 - t0, "images": seen,
                                 "validate_s": t2 - t1,
                                 "save_s": time.perf_counter() - t2})
        return last_metrics


def _targets_to_samples(images: np.ndarray, targets) -> List[MeshEstimationSample]:
    """Padded targets -> per-image MeshEstimationSample for the metrics."""
    gt_bboxes = np.asarray(targets.gt_bboxes)
    gt_v2d = np.asarray(targets.gt_vertices_2d, np.float32)
    gt_v3d = np.asarray(targets.gt_vertices_3d, np.float32)
    gt_rot = np.asarray(targets.gt_rotations)
    mask = np.asarray(targets.pad_gt_mask)[..., 0] > 0
    samples = []
    for i in range(images.shape[0]):
        keep = mask[i]
        xyxy = gt_bboxes[i][keep]
        xywh = np.stack([xyxy[:, 0], xyxy[:, 1], xyxy[:, 2] - xyxy[:, 0],
                         xyxy[:, 3] - xyxy[:, 1]], axis=1)
        samples.append(MeshEstimationSample(
            image=images[i],
            vertices_2d=gt_v2d[i][keep],
            vertices_3d=gt_v3d[i][keep],
            rotation_matrix=gt_rot[i][keep],
            areas=xywh[:, 2] * xywh[:, 3],
            bboxes_xywh=xywh,
            is_crowd=np.zeros(keep.sum(), bool),
        ))
    return samples
