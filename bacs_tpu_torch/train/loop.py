"""The continual task loop: ``Trainer(config).fit()`` -> final mIoU.

Port of ``bacs_tpu/train/loop.py`` on one device (the card unless the
caller asks for the CPU) or data-parallel over the ranks of a process
group (``parallel/``; for ``training.n_devices`` > 1
``bacs_tpu_torch.main`` spawns one rank per card, or per CPU process with
``--device cpu``).  Per task: head surgery by the learner and a fresh
optimizer under the task's schedule -> ``begin_task`` -> the epochs
of train steps, with mid-epoch checkpoints (written in the background, as
the JAX loop's ``block=False``) and periodic validation ->
``end_task`` on the task's unaugmented batches -> the test over tasks
0..t with the reference's metric keys (and the seen detector's aux
metrics when it is on) -> ``PerStepResult``.  A run resumes from the
newest checkpoint, mid-task or after a task (reference: trainer.py:57-433).

The JAX loop builds a Flax model per task; here one ``nn.Module`` lives in
the ``TrainState`` across tasks (its head holds every class from the
start; a task's classes are the first ``nb_current_classes``), with the
frozen previous model beside it, and the steps of ``train/step.py`` update
it in place.

Data parallelism, as the JAX loop's mesh (``loop.py:60-120,350-423``): the
train steps run on each rank's slice of a global batch of ``batch_size x
n_devices`` (the epoch's steps and the schedule count global batches),
and the eval passes on each rank's slice, their matrices summed.  The
task-boundary passes (head surgery, ``begin_task``, ``end_task``'s sweeps
and buffer fill) run on every rank alike, on loader-sized streams, with a
context that names no group, so no norm synchronizes there and the
ranks' states stay identical.  Only rank 0 logs and writes checkpoints;
the others wait at a barrier after each task's final save, and every
rank resumes from the same file.

Not ported, because they exist only for the TPU or its host; a config that
sets one gets one log line that it is ignored: multihost streams,
``training.spatial_partition`` (GSPMD),
``training.boundary_gc`` (XLA's executable cache) and
``training.steps_per_dispatch`` (``make_multi_step``).  On the card the
Trainer sets cuDNN's deterministic algorithms, so that with the
counter-based draws (``ops/rng.py``) and the kernels' fixed-order sums two
runs of one seed end with the same weights.
``training.profile_dir`` traces task 0's step loop, as JAX's
``jax.profiler`` trace does (``bacs_tpu/train/loop.py:441-442,584-586``):
``torch.profiler`` from before the first step to after the last, the CPU's
activity and, on the card, CUDA's, written as one Chrome trace per rank
(``trace.json``, or ``trace_rank<r>.json`` under data parallelism).  There
is no knob for the window: a long task 0 gives a large trace, as in JAX.
The Trainer logs the DataModule's host decoder (native or PIL) at start.
After each task's test the callbacks run (``_run_callbacks``): media collages
(``training.log_images``), prototype plots (``log_prototypes``), the drift
snapshot (``log_drift``, measured every ``drift_measure_every`` train
steps of the later tasks and logged as ``representation_drift``), all
written under ``training.media_dir``, and with the detector an ``ood``
dataset's OOD pass (``test.0_aux_ood/*``).  Asking for more cards than are
visible warns and runs on those there are, as the JAX loop does.  A
``network.backbone_weights_path`` that exists is loaded into the new
network's backbone (the PLOP release layout, ``utils/torch_weights.py``);
one that does not is logged, and the network trains from its seeded
weights, as in JAX.  A seed names JAX's run: the network's initial weights
are the ones JAX's ``model.init`` draws for it (``utils/flax_init.py``) and
the state's key is JAX's ``r_state``, split by each train step as JAX
splits it.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from bacs_tpu_torch import parallel
from bacs_tpu_torch.data.datamodule import create_datamodule
from bacs_tpu_torch.methods import create_method
from bacs_tpu_torch.methods.base import ModelContext
from bacs_tpu_torch.models import create_network
from bacs_tpu_torch.models.transeg import TranSeg
from bacs_tpu_torch.train.learner import get_learner, transformer_init
from bacs_tpu_torch.train.metrics import PerStepResult, detailed_iou_metrics
from bacs_tpu_torch.train.ood import aux_bg_step, aux_bg_summary, ood_test
from bacs_tpu_torch.train.optim import make_optimizer, make_schedule
from bacs_tpu_torch.train.state import TaskInfo, TrainState, frozen_copy
from bacs_tpu_torch.train.step import make_steps
from bacs_tpu_torch.utils import checkpoint
from bacs_tpu_torch.utils.flax_init import init_weights, trainer_keys
from bacs_tpu_torch.utils.logging import Logger
from bacs_tpu_torch.utils.torch_weights import load_backbone_into
from bacs_tpu_torch.viz.drift import DriftProbe
from bacs_tpu_torch.viz.media import MediaLogger
from bacs_tpu_torch.viz.prototypes_viz import PrototypeLogger

# training keys that tune the TPU or its host, ignored here
TPU_ONLY_KEYS = ("spatial_partition", "boundary_gc", "steps_per_dispatch")


def requested_devices(config) -> int:
    """``training.n_devices`` (or the reference's ``n_gpus``), at least 1."""
    tcfg = config["training"]
    return max(int(tcfg.get("n_devices", tcfg.get("n_gpus", 1)) or 1), 1)


def available_devices(device: torch.device | str) -> int:
    """Ranks a run on ``device`` may have: the visible cards, or on the CPU
    any number (gloo ranks, the counterpart of JAX's virtual CPU devices)."""
    if torch.device(device).type == "cuda":
        return torch.cuda.device_count()
    return 1 << 30


class Trainer:
    """``Trainer(config, device).fit()`` -> final mIoU (reference:
    trainer.py:57,415).  ``group`` is the process group of a data-parallel
    run (this process one of its ranks, on ``device``); without one the
    group already running in this process, or the one ``torchrun``
    describes, is joined when ``training.n_devices`` asks for more than
    one device."""

    def __init__(self, config, datamodule=None, device: torch.device | str = "cuda",
                 group=None):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "Trainer(device='cuda') but torch sees no CUDA device; pass "
                "device='cpu' (--device cpu) to train on the CPU"
            )
        if self.device.type == "cuda":
            # cuDNN's deterministic algorithms: with the counter-based draws
            # and the kernels' fixed-order sums, a run on the card is a
            # function of its seed (they cost the CE and BACS steps 0.06 and
            # 0.35 % of their busy time on an H100, PERF.md)
            torch.backends.cudnn.deterministic = True
            torch.backends.cudnn.benchmark = False
        self.config = config
        tcfg = config["training"]
        n_dev = requested_devices(config)
        if group is None and n_dev > 1:
            group = parallel.join_env(self.device)
        self.group = group
        self.rank = parallel.rank(group)
        self.n_devices = parallel.world_size(group)
        self.seed = int(tcfg.get("seed", 42))
        self.logger = Logger(enabled=self.rank == 0)
        self.datamodule = datamodule or create_datamodule(config, self.device)
        dm = self.datamodule
        self.continual = dm.continual
        self.n_tasks = dm.n_tasks
        self.epochs = int(tcfg.get("epochs", 1))
        self.next_epochs = int(tcfg.get("next_epochs", self.epochs) or self.epochs)
        # mini-steps per optimizer update (bacs_tpu/train/loop.py:232,444)
        self.accumulate = int(tcfg.get("accumulate_gradients", 1) or 1)
        self.steps_per_class = tcfg.get("steps_per_class", None)
        self.mixed_precision = bool(tcfg.get("mixed_precision", False))
        self.use_bg_detector = bool(tcfg.get("bg_detector", False))
        self.lr_next = tcfg.get("lr_next", None)
        self.ignore_index = 255

        if self.n_devices < n_dev:
            # the reference's DDP would fail here; warn instead of silently
            # downgrading (bacs_tpu/train/loop.py:67-75).  Ranks are processes:
            # bacs_tpu_torch.main.train (or torchrun) starts them
            self.logger.info(
                f"WARNING: training.n_devices={n_dev} requested but this process is "
                f"one of {self.n_devices} rank(s) (visible: "
                f"{min(n_dev, available_devices(self.device))}) — running on "
                f"{self.n_devices}.  "
                "Global batch/LR semantics differ from the requested topology.")
        for key in TPU_ONLY_KEYS:
            if key in tcfg:
                self.logger.info(f"training.{key}={tcfg[key]!r} tunes the TPU or its "
                                 "host and is ignored")
        self.logger.info(f"host decode: {dm.decoder}")
        # task 0's step loop under torch.profiler (bacs_tpu/train/loop.py:177-179)
        self.profile_dir = tcfg.get("profile_dir", None)
        # observability callbacks (bacs_tpu/train/loop.py:156-175; reference:
        # visualization/, trainer.py:203-223), run after each task's test
        out_dir = str(tcfg.get("media_dir", "media"))
        self.media = MediaLogger(out_dir) if tcfg.get("log_images", False) else None
        self.proto_logger = (PrototypeLogger(out_dir) if tcfg.get("log_prototypes", False)
                             else None)
        self.drift = (DriftProbe(measure_every=int(tcfg.get("drift_measure_every", 50)))
                      if tcfg.get("log_drift", False) else None)
        # the OOD pass (reference: trainer.py:120-123,406-411)
        self.ood_config = config.get("ood", None)
        self.fused_ce = bool(tcfg.get("fused_ce", True))

        # method (reference loss plugin, trainer.py:242-252)
        lcfg = dict(config.get("loss", {}))
        target = lcfg.pop("_target_", "loss.CrossEntropy")
        lcfg.pop("name", None)
        self.method = create_method(
            target, ignore_index=self.ignore_index, use_bg_detector=self.use_bg_detector,
            **lcfg)
        learner_cfg = tcfg.get("learner", {}) or {}
        self.learner_init = get_learner(learner_cfg.get(
            "_target_",
            "learner.SingleHeadLearner" if self.continual else "learner.BaseLearner"))
        # TranSeg's new class tokens (bacs_tpu/train/loop.py:139,381-384)
        self.new_token_init = str(tcfg.get("new_token_init", "random"))
        self.per_step_metric = PerStepResult(self.continual)
        self.state: Optional[TrainState] = None
        self._timing = {"images": 0, "seconds": 0.0}
        # wall seconds per task: the boundary (surgery, optimizer, begin_task),
        # the train steps, end_task and the test
        self.task_seconds: List[Dict[str, float]] = []
        # checkpointing (reference: trainer.py:133-179; resume disabled in
        # debug mode, trainer.py:261)
        self.ckpt_dir = tcfg.get("ckpt_dir", None)
        self.resume_enabled = bool(self.ckpt_dir) and not bool(tcfg.get("debug", False))
        self.save_checkpoints = bool(self.ckpt_dir)
        # one writer in a data-parallel run: rank 0
        self.writes_checkpoints = self.save_checkpoints and self.rank == 0
        # mid-task saves write in the background (bacs_tpu/train/loop.py:553-558)
        self.saver = checkpoint.AsyncSaver()
        self.strict_restore = bool(tcfg.get("strict_restore", False))
        self._resume_epoch = -1
        self._skip_surgery = False

    # ------------------------------------------------------------------

    def _task_info(self, task_id: int) -> TaskInfo:
        dm = self.datamodule
        tcfg = self.config["training"]
        # a domain task sees every class (bacs_tpu/train/loop.py:183-202)
        domain = getattr(dm, "domain_shift", False)
        if self.continual and not domain:
            initial = int(tcfg.get("initial_increment", 0)) + 1  # + background
            inc = int(tcfg.get("increment", 0))
        else:
            initial = dm.num_classes
            inc = 0
        return TaskInfo(
            task_id=task_id, initial_classes=initial, increment=inc,
            num_classes=dm.num_classes, n_tasks=self.n_tasks,
            max_epochs=self._epochs_for(task_id), ignore_index=self.ignore_index,
            domain_shift=domain,
        )

    def _epochs_for(self, task_id: int) -> int:
        return self.epochs if task_id == 0 else self.next_epochs

    def _make_model(self) -> torch.nn.Module:
        """The network, in bf16 convolutions on f32 master weights with
        ``training.mixed_precision``, weights drawn from the seed, on the
        trainer's device."""
        ncfg = dict(self.config.get("network", {}))
        target = ncfg.pop("_target_", "networks.DeepLabV3")
        model = create_network(
            target, num_classes=self.datamodule.num_classes, n_tasks=self.n_tasks,
            use_bg_detector=self.use_bg_detector, norm=str(ncfg.get("norm", "iabn_sync")),
            crop_size=self.datamodule.crop_size,
            dtype=torch.bfloat16 if self.mixed_precision else torch.float32,
            param_dtype=torch.float32,
            **{k: v for k, v in ncfg.items()
               if k in ("backbone", "output_stride", "n_channels", "bilinear",
                        "num_layers", "transformer", "atrous_encoder", "remat",
                        "fused_abn", "fused_stem")},
        )
        init_weights(model, self.seed)
        return model.to(self.device)

    def _max_iters(self, task: TaskInfo) -> int:
        """The task's optimizer updates: the schedule's length."""
        steps_epoch = -(-self.datamodule.steps_per_epoch(self.n_devices) // self.accumulate)
        total = steps_epoch * self._epochs_for(task.task_id)
        if self.steps_per_class:
            # ReCall-style budget (reference: trainer.py:322-327)
            total = min(total, int(self.steps_per_class) * task.nb_new_classes)
        return max(total, 1)

    def _make_tx(self, task: TaskInfo, model: torch.nn.Module):
        ocfg = dict(self.config.get("optimizer", {}))
        base_lr = float(ocfg.get("lr", 0.01))
        if task.task_id > 0 and self.lr_next is not None:
            base_lr = float(self.lr_next)  # (reference: model.py:101-108)
        schedule = make_schedule(self.config.get("scheduler"), base_lr, self._max_iters(task))
        return make_optimizer(ocfg, model.parameters(), schedule, grad_clip_value=2.0,
                              accumulate_steps=self.accumulate)

    # ------------------------------------------------------------------

    def _init_state(self, task: TaskInfo) -> TrainState:
        crop = self.datamodule.crop_size
        model = self._make_model()
        # pretrained backbone (reference: deeplab_v3.py:36-49)
        bw_path = self.config.get("network", {}).get("backbone_weights_path")
        if bw_path and os.path.isfile(os.path.expanduser(str(bw_path))):
            n = load_backbone_into(model, str(bw_path))
            self.logger.info(f"loaded {n} pretrained backbone tensors from {bw_path}")
        elif bw_path:
            self.logger.info(f"backbone weights path {bw_path} not found; "
                             "training from scratch")
        # probe the sem-logit size and the penultimate width
        with torch.no_grad():
            out = model.eval()(torch.zeros((1, crop, crop, 3), device=self.device))
        sem_hw = tuple(out.sem_logits.shape[1:3])
        pen_dim = out.penultimate.shape[-1]
        buffer = None
        if self.method.needs_buffer:
            buffer = self.method.init_buffer(task, (crop, crop), sem_hw, device=self.device)
        state = TrainState(
            model, *self._make_tx(task, model), key=trainer_keys(self.seed)[2],
            prototypes=torch.zeros((self.n_tasks, pen_dim), device=self.device),
            proto_counts=torch.zeros((self.n_tasks,), device=self.device),
            buffer=buffer,
        )
        if self.method.needs_class_prototypes:  # SDR (bacs_tpu/train/loop.py:295-304)
            c = self.datamodule.num_classes
            state.class_prototypes = torch.zeros((c, pen_dim), device=self.device)
            state.class_proto_counts = torch.zeros((c,), device=self.device)
        n_params = sum(p.numel() for p in model.parameters())
        self.logger.info(f"model parameters: {n_params / 1e6:.2f} M")
        return state

    # ------------------------------------------------------------------

    def _run_task(self, task_id: int) -> List[Dict[str, float]]:
        dm = self.datamodule
        dm.set_task_id(task_id)
        t_start = time.perf_counter()
        task = self._task_info(task_id)
        ctx = ModelContext(task, fused_ce=self.fused_ce, group=self.group)
        # the boundary passes name no group (bacs_tpu/train/loop.py:364-371)
        boundary_ctx = ModelContext(task, fused_ce=self.fused_ce)
        if self.state is None:
            self.state = self._init_state(task)
        elif self._skip_surgery:
            # mid-task resume: heads already initialized, optimizer state
            # restored from the checkpoint
            self._skip_surgery = False
        else:
            # head surgery for the new classes, fresh optimizer/schedule
            if self.learner_init is transformer_init:
                self.state = self.learner_init(self.state, task, self.new_token_init)
            else:
                self.state = self.learner_init(self.state, task)
            self.state.optimizer, self.state.scheduler = self._make_tx(task, self.state.model)
        self._set_active_classes(task)
        # loader-sized streams at the boundary (bacs_tpu/train/loop.py:405-414)
        self.state = self.method.begin_task(self.state, boundary_ctx, dm.train_batches(epoch=0))
        train_step, eval_step, put_batch = make_steps(ctx, self.method, dm.num_classes,
                                                      device=self.device)
        t_train = time.perf_counter()
        profiler = self._start_profile() if self.profile_dir and task_id == 0 else None

        try:  # the profiler stops and writes its trace also where a step raises
            max_iters = self._max_iters(task) * self.accumulate  # mini-steps
            step_count = 0
            steps_epoch = dm.steps_per_epoch(self.n_devices)
            # mid-task resume restarts the SAME epoch and skips the batches the
            # restored epoch_step says were already consumed (the per-epoch data
            # order is deterministic); a full epoch_step means the epoch finished.
            resume_skip = 0
            if self._resume_epoch >= 0:
                start_epoch = self._resume_epoch
                resume_skip = int(self.state.epoch_step)
                if resume_skip >= steps_epoch:
                    start_epoch += 1
                    resume_skip = 0
            else:
                start_epoch = 0
            self._resume_epoch = -1
            # mid-epoch checkpoint cadence: twice per epoch like the reference
            # (trainer.py:190-201), overridable via training.ckpt_every_steps
            ckpt_every = int(self.config["training"].get("ckpt_every_steps", 0)
                             or max(steps_epoch // 2, 1))
            last_slot = 0  # alternate last0/last1: a crash mid-save keeps the other
            for epoch in range(start_epoch, self._epochs_for(task_id)):
                skip = resume_skip if epoch == start_epoch else 0
                saved_chunks = skip // ckpt_every if ckpt_every else 0
                self.state.epoch, self.state.epoch_step = epoch, skip
                batches = dm.train_batches(epoch=epoch, n_devices=self.n_devices,
                                           rank=self.rank if self.group is not None else None)
                for i, batch in enumerate(batches):
                    if i < skip:
                        step_count += 1  # already consumed before the interruption
                        continue
                    if step_count >= max_iters:
                        # a run resumed at its step budget trains no further step
                        # (the JAX loop trains one: ROADMAP.md queue 3)
                        break
                    t0 = time.perf_counter()
                    self.state, metrics = train_step(self.state, put_batch(batch))
                    step_count += 1
                    if self.drift is not None and task_id > 0 and self.rank == 0:
                        d = self.drift.measure(ctx, self.state, step_count)
                        if d is not None:
                            self.logger.log_metrics({"representation_drift": d})
                    if step_count <= 2 or step_count % 50 == 0:
                        self.logger.info(f"task {task_id} epoch {epoch} step {step_count} "
                                         f"loss {float(metrics['loss']):.4f}")
                    if step_count > 2:
                        float(metrics["loss"])  # a host read, so the time is real
                        dt = time.perf_counter() - t0
                        if dt < 5.0:  # leave out first-call compilations
                            self._timing["images"] += batch["image"].shape[0] * self.n_devices
                            self._timing["seconds"] += dt
                    if (self.writes_checkpoints and ckpt_every
                            and (i + 1) // ckpt_every > saved_chunks and (i + 1) < steps_epoch):
                        saved_chunks = (i + 1) // ckpt_every
                        checkpoint.save_task_checkpoint(self.ckpt_dir, task_id, self.state,
                                                        f"last{last_slot}", self.saver,
                                                        block=False)
                        last_slot = 1 - last_slot
                    if step_count >= max_iters:
                        break
                # periodic validation on the current (and previous) task's val set
                # (reference: training.val_every; model.py:385 dual val loaders)
                val_every = int(self.config["training"].get("val_every", 0) or 0)
                if (val_every and (epoch + 1) % val_every == 0
                        and epoch + 1 < self._epochs_for(task_id)):
                    self._run_validation(task_id, ctx, eval_step, put_batch, epoch)
                if self.writes_checkpoints:
                    checkpoint.save_task_checkpoint(self.ckpt_dir, task_id, self.state,
                                                    f"last{last_slot}", self.saver, block=False)
                    last_slot = 1 - last_slot
                if step_count >= max_iters:
                    break
        finally:
            if profiler is not None:
                self._stop_profile(profiler)
        t_end = time.perf_counter()

        # buffers are populated from CANONICAL (non-augmented) images; replay
        # re-augments per step (reference: base_datamodule.py:433-451)
        self.state = self.method.end_task(self.state, boundary_ctx,
                                          dm.train_batches(epoch=0, augment=False))
        if self.writes_checkpoints:  # blocking, after the pending write
            checkpoint.save_task_checkpoint(self.ckpt_dir, task_id, self.state, "final",
                                            self.saver)
        self._barrier()
        t_test = time.perf_counter()
        results = self._run_test(task_id, ctx, eval_step, put_batch)
        t_done = time.perf_counter()
        self.task_seconds.append({
            "boundary": t_train - t_start, "train": t_end - t_train,
            "end_task": t_test - t_end, "test": t_done - t_test, "wall": t_done - t_start})
        return results

    def _start_profile(self):
        """A started ``torch.profiler`` of the CPU and, on the card, CUDA."""
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        profiler = profile(activities=activities)
        profiler.start()
        return profiler

    def _stop_profile(self, profiler) -> None:
        """Stop ``profiler`` and write its Chrome trace into ``profile_dir``."""
        profiler.stop()
        name = "trace.json" if self.group is None else f"trace_rank{self.rank}.json"
        path = os.path.join(os.path.expanduser(str(self.profile_dir)), name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        profiler.export_chrome_trace(path)
        self.logger.info(f"profiler trace written to {path}")

    def _set_active_classes(self, task: TaskInfo) -> None:
        """TranSeg's class tokens in use: the task's classes, on the model
        and on the previous model too.  The JAX teacher is the current
        task's module applied to the previous parameters
        (``bacs_tpu/methods/base.py:82-89``), so it attends over the current
        count of tokens, the new ones with their values from before the
        surgery (the previous model was copied at ``end_task``)."""
        for model in (self.state.model, self.state.prev_model):
            if isinstance(model, TranSeg):
                model.active_classes = task.nb_current_classes

    def _eval_pass(self, d, eval_step, put_batch, ctx=None):
        """(confusion matrix, sample-weighted mean loss, aux matrix, aux
        statistics, first batch) of task ``d``'s eval batches; the aux pair
        with ``ctx``."""
        dm = self.datamodule
        conf = torch.zeros((dm.num_classes, dm.num_classes), dtype=torch.int32,
                           device=self.device)
        conf_aux = torch.zeros((2, 2), dtype=torch.int32, device=self.device)
        losses, weights, aux_stats = [], [], []
        first = None
        for batch in dm.eval_batches(d, n_devices=self.n_devices,
                                     rank=self.rank if self.group is not None else None):
            # padded tail batches count only their real samples
            # (reference: PL batch-size weighting)
            weights.append(batch.pop("n_real"))
            batch = put_batch(batch)
            first = batch if first is None else first
            conf, loss = eval_step(self.state, conf, batch)
            losses.append(loss)
            if ctx is not None:
                conf_aux, stats = aux_bg_step(ctx, self.state, batch, conf_aux)
                aux_stats.append(stats)
        loss = float(np.average([float(v) for v in losses], weights=weights))
        return conf.cpu().numpy(), loss, conf_aux.cpu().numpy(), aux_stats, first

    def _run_validation(self, task_id, ctx, eval_step, put_batch, epoch):
        """Mid-training val pass: current task (+ previous task as `prev`)
        (reference: Model.validation_step, training/model.py:385-424)."""
        task = ctx.task
        targets = [("val", task_id)]
        if self.continual and task_id > 0:
            targets.append(("prev", task_id - 1))
        for prefix, t in targets:
            conf, loss, _, _, _ = self._eval_pass(t, eval_step, put_batch)
            metrics = detailed_iou_metrics(conf, initial_classes=task.initial_classes,
                                           nb_current_classes=task.nb_current_classes)
            self.logger.log_metrics({f"{prefix}/mIoU": metrics["mIoU"],
                                     f"{prefix}/loss": loss, f"{prefix}/epoch": epoch})

    def _run_test(self, task_id, ctx, eval_step, put_batch):
        """Eval over tasks 0..t (reference: trainer.py:371-383)."""
        dm = self.datamodule
        task = ctx.task
        results: List[Dict[str, float]] = []
        first_batch = None
        for d in dm.eval_task_range(task_id):
            conf, loss, conf_aux, aux_stats, first = self._eval_pass(
                d, eval_step, put_batch, ctx if self.use_bg_detector else None)
            first_batch = first if first_batch is None else first_batch
            metrics = detailed_iou_metrics(
                conf, initial_classes=task.initial_classes,
                nb_current_classes=task.nb_current_classes, class_names=dm.class_names)
            prefix = f"test.{d}/Task {task_id}/" if self.continual else f"test.{d}/"
            result = {prefix + k: v for k, v in metrics.items()}
            result[prefix + "loss"] = loss
            if self.use_bg_detector:
                aux = aux_bg_summary(conf_aux)
                # seen-probability statistics: batch means of the per-batch
                # mean/var (reference: ood_model.py:103-171)
                for k in aux_stats[0] if aux_stats else ():
                    aux[k] = float(np.mean([float(s[k]) for s in aux_stats]))
                self.logger.log_metrics({f"test.{d}_aux_bg/{k}": v for k, v in aux.items()})
            self.logger.log_metrics(result)
            results.append(result)
        self._run_callbacks(task_id, ctx, first_batch)
        return results

    def _global_batch(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The global batch of which ``batch`` is this rank's slice, on
        every rank (the slices are contiguous and of one size)."""
        if self.group is None:
            return batch
        return {k: parallel.all_gather(batch[k], self.group) for k in ("image", "label")}

    @torch.no_grad()
    def _run_callbacks(self, task_id, ctx, first_batch):
        """Media, prototype, drift and OOD passes after a task's test
        (``bacs_tpu/train/loop.py:712-765``; reference: the visualization
        callbacks and trainer.py:406-411).  The media and drift samples are
        the first global batch; the prototype and OOD sums are summed across
        the ranks; only rank 0 writes, measures and logs."""
        dm = self.datamodule
        writer = self.rank == 0
        if first_batch is not None and (self.media is not None or self.drift is not None):
            first_batch = self._global_batch(first_batch)
        if first_batch is not None and self.media is not None and writer:
            logits = ctx.forward(self.state.model, first_batch["image"], False).logits
            preds = torch.argmax(logits[..., :ctx.n_cur], dim=-1)
            self.media.append("test", first_batch["image"], first_batch["label"], preds)
            path = self.media.flush(task_id)
            if path:
                self.logger.info(f"media collage: {path}")
            self.media.log_wandb(self.logger, task_id, dm.class_names)
        if self.proto_logger is not None:
            collected = self.proto_logger.collect(
                ctx, self.state, dm.eval_batches(
                    0, n_devices=self.n_devices,
                    rank=self.rank if self.group is not None else None))
            if writer:
                for p in self.proto_logger.plot(ctx, self.state, collected, task_id):
                    self.logger.info(f"prototype plot: {p}")
        if self.drift is not None and first_batch is not None and writer:
            self.drift.snapshot(ctx, self.state, first_batch)
        if self.ood_config is not None and self.use_bg_detector:
            ood_dm = create_datamodule(
                {"dataset": self.ood_config,
                 "training": dict(self.config["training"], initial_increment=0, increment=0)},
                self.device)
            metrics = ood_test(ctx, self.state, ood_dm.eval_batches(
                0, n_devices=self.n_devices,
                rank=self.rank if self.group is not None else None))
            ood_dm.close()
            self.logger.log_metrics({f"test.0_aux_ood/{k}": v for k, v in metrics.items()})

    # ------------------------------------------------------------------

    def _try_resume(self) -> int:
        """Restore the newest checkpoint; returns the first task to train
        (reference: trainer.py:254-268 task-indexed resume)."""
        if not self.resume_enabled:
            return 0
        self.saver.wait()
        found = checkpoint.latest_checkpoint(self.ckpt_dir)
        if not found:
            return 0
        t_ckpt, path = found
        is_final = path.endswith("final")
        template = self._template(t_ckpt, path)
        try:
            self.state = checkpoint.restore_checkpoint(path, template)
        except Exception as e:  # structure drift → start fresh (or raise)
            if self.strict_restore:
                raise RuntimeError(f"training.strict_restore: cannot resume from {path}") from e
            self.logger.info(f"resume failed ({e}); starting fresh")
            self.state = None
            return 0
        if is_final:
            self.logger.info(f"resumed after completed task {t_ckpt}: {path}")
            return t_ckpt + 1
        self._resume_epoch = int(self.state.epoch)
        self._skip_surgery = True
        self.logger.info(f"resumed mid-task {t_ckpt} at epoch {self._resume_epoch}: {path}")
        return t_ckpt

    def _template(self, task_id: int, path: str) -> TrainState:
        """A fresh state of the structure of task ``task_id``'s checkpoint
        at ``path``."""
        # the template's schedule is the task's own: its step budget counts
        # the task's batches (the JAX loop rebuilds its optax chain per task)
        self.datamodule.set_task_id(task_id)
        template = self._init_state(self._task_info(task_id))
        if self.method.needs_prev_model and (task_id > 0 or path.endswith("final")):
            template.prev_model = frozen_copy(template.model)
        return template

    def restore(self, task_id: int, path: str) -> TrainState:
        """The checkpoint at ``path`` of task ``task_id``, restored into a
        state of the same structure (a structure mismatch raises)."""
        return checkpoint.restore_checkpoint(path, self._template(task_id, path))

    def fit(self) -> float:
        """The outer task loop (reference: trainer.py:415-433).  A pending
        checkpoint write is waited for when it ends or raises."""
        try:
            start_task = self._try_resume()
            # metric keys are task-indexed; resumed runs start aggregating at
            # the resumed task (earlier tasks' metrics lived in the logs)
            self.per_step_metric.task_id = start_task
            for task_id in range(start_task, self.n_tasks):
                self.logger.info(
                    f"=== task {task_id + 1}/{self.n_tasks} "
                    f"(classes ≤ {self._task_info(task_id).nb_current_classes}) ===")
                results = self._run_task(task_id)
                self.per_step_metric.update(results)
        finally:
            self.saver.wait()
        self._barrier()
        self._log_final_results()
        return self.per_step_metric.final_miou

    def _barrier(self):
        """Every rank waits here for the others (rank 0's writes)."""
        if self.group is not None:
            dist.barrier(group=self.group)

    def _log_final_results(self):
        """(reference: trainer.py:352-369 `_log_final_results`)."""
        final = self.per_step_metric.compute()
        for metric, values in final.items():
            if metric == "Avg-IoU":
                for d, v in enumerate(np.atleast_1d(values)):
                    self.logger.log_metrics({f"Final/test.{d}/Avg-IoU": float(v)})
                continue
            for d, v in enumerate(values):
                self.logger.log_metrics({f"Final/test.{d}/{metric}": float(v)})

    @property
    def throughput(self) -> float:
        """Steady-state train images/sec."""
        if self._timing["seconds"] == 0:
            return 0.0
        return self._timing["images"] / self._timing["seconds"]
