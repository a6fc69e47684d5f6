"""The continual task loop: ``Trainer(config).fit()`` -> final mIoU.

Port of ``bacs_tpu/train/loop.py`` on one device (the card unless the
caller asks for the CPU).  Per task: head surgery by the learner and a
fresh optimizer under the task's schedule -> ``begin_task`` -> the epochs
of train steps, with mid-epoch checkpoints and periodic validation ->
``end_task`` on the task's unaugmented batches -> the test over tasks
0..t with the reference's metric keys (and the seen detector's aux
metrics when it is on) -> ``PerStepResult``.  A run resumes from the
newest checkpoint, mid-task or after a task (reference: trainer.py:57-433).

The JAX loop builds a Flax model per task; here one ``nn.Module`` lives in
the ``TrainState`` across tasks (its head holds every class from the
start; a task's classes are the first ``nb_current_classes``), with the
frozen previous model beside it, and the steps of ``train/step.py`` update
it in place.

Not ported, because they exist only for the TPU or its host; a config that
sets one gets one log line that it is ignored: the device mesh and
multihost streams, ``training.spatial_partition`` (GSPMD),
``training.boundary_gc`` (XLA's executable cache),
``training.steps_per_dispatch`` (``make_multi_step``) and
``training.profile_dir`` (the ``jax.profiler`` trace).  These raise, naming
their ROADMAP.md item: more than one card asked for where more than one
is visible (queue 1 item 10); media,
prototype and drift logging and the OOD pass (item 14); a
``backbone_weights_path`` that exists (item 13).  Asking for more devices
than are visible warns and runs on one, as the JAX loop does.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from bacs_tpu_torch.data.datamodule import create_datamodule
from bacs_tpu_torch.methods import create_method
from bacs_tpu_torch.methods.base import ModelContext
from bacs_tpu_torch.models import create_network
from bacs_tpu_torch.models.layers import Linear
from bacs_tpu_torch.models.resnet import Conv2d
from bacs_tpu_torch.models.transeg import TranSeg
from bacs_tpu_torch.models.unet import ConvTranspose2d, UNet
from bacs_tpu_torch.train.learner import get_learner, transformer_init
from bacs_tpu_torch.train.metrics import PerStepResult, detailed_iou_metrics
from bacs_tpu_torch.train.ood import aux_bg_step, aux_bg_summary
from bacs_tpu_torch.train.optim import make_optimizer, make_schedule
from bacs_tpu_torch.train.state import TaskInfo, TrainState, frozen_copy
from bacs_tpu_torch.train.step import make_steps
from bacs_tpu_torch.utils import checkpoint
from bacs_tpu_torch.utils.logging import Logger

# training keys that tune the TPU or its host, ignored here
TPU_ONLY_KEYS = ("spatial_partition", "boundary_gc", "steps_per_dispatch", "profile_dir")


def _lecun_normal(shape, fan_in: int, g: torch.Generator) -> torch.Tensor:
    """Flax's default kernel initialiser: a normal truncated at two standard
    deviations, scaled to variance 1 / fan_in."""
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    return torch.nn.init.trunc_normal_(torch.empty(shape), std=std, a=-2 * std, b=2 * std,
                                       generator=g)


# convolutions of DeepLabV3 and TranSeg that keep Flax's default initialiser
FLAX_DEFAULT_CONVS = ("classifier_head", "seen_fg_network.base_conv",
                      "base_classifier.feature_embedding")


def init_weights(model: torch.nn.Module, seed: int) -> None:
    """Draw the network's weights as the JAX package initialises them, from
    ``seed``.  The ResNet backbone's and the ASPP's convolutions are
    He-normal over the fan-out (``bacs_tpu/models/resnet.py:59``); every
    other convolution keeps Flax's default, LeCun-normal truncated over the
    fan-in (kh kw in): the classifier, TranSeg's feature embedding, the
    detector's trunk convolution, and every UNet convolution and transpose
    convolution; so does every TranSeg ``Dense`` (``Linear``, over its
    inputs).  The detector's heads are LeCun-normal over D x T; biases 0.
    TranSeg's head draws as ``bacs_tpu/models/transeg.py`` declares it:
    ``pos_embed`` normal(1), ``class_tokens`` 0.02 x a standard normal
    truncated to [-2, 2], ``proj_*`` normal(D^-1/2), LayerNorms and
    ``mask_norm`` 1 and 0.  The numbers differ from JAX's (another
    generator)."""
    g = torch.Generator().manual_seed(seed)
    flax_default = isinstance(model, UNet)
    with torch.no_grad():
        for name, m in model.named_modules():
            if isinstance(m, torch.nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
                continue
            if isinstance(m, Linear):
                w = _lecun_normal(m.weight.shape, m.in_features, g)
            elif isinstance(m, ConvTranspose2d):
                in_c, _, kh, kw = m.weight.shape
                w = _lecun_normal(m.weight.shape, in_c * kh * kw, g)
            elif isinstance(m, Conv2d):
                out_c, in_c, kh, kw = m.weight.shape
                if flax_default or name in FLAX_DEFAULT_CONVS:
                    w = _lecun_normal(m.weight.shape, in_c * kh * kw, g)
                else:
                    w = torch.randn(m.weight.shape, generator=g) * (2.0 / (out_c * kh * kw)) ** 0.5
            else:
                continue
            m.weight.copy_(w)
            if m.bias is not None:
                m.bias.zero_()
        det = getattr(model, "seen_fg_network", None)
        if det is not None:
            t, d, _ = det.head_kernel.shape
            det.head_kernel.copy_(_lecun_normal(det.head_kernel.shape, d * t, g))
        if isinstance(model, TranSeg):
            head = model.base_classifier
            d = head.proj_patch.shape[0]
            head.pos_embed.copy_(torch.randn(head.pos_embed.shape, generator=g))
            head.class_tokens.copy_(torch.nn.init.trunc_normal_(
                torch.empty(head.class_tokens.shape), std=0.02, a=-0.04, b=0.04,
                generator=g))
            for p in (head.proj_patch, head.proj_classes):
                p.copy_(torch.randn(p.shape, generator=g) * d ** -0.5)
            head.mask_norm_scale.fill_(1.0)
            head.mask_norm_bias.zero_()


class Trainer:
    """``Trainer(config, device).fit()`` -> final mIoU (reference:
    trainer.py:57,415)."""

    def __init__(self, config, datamodule=None, device: torch.device | str = "cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "Trainer(device='cuda') but torch sees no CUDA device; pass "
                "device='cpu' (--device cpu) to train on the CPU"
            )
        self.config = config
        tcfg = config["training"]
        self.seed = int(tcfg.get("seed", 42))
        self.logger = Logger()
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

        n_dev = int(tcfg.get("n_devices", tcfg.get("n_gpus", 1)) or 1)
        avail = torch.cuda.device_count() if self.device.type == "cuda" else 1
        if n_dev > 1 and avail > 1:
            raise NotImplementedError(
                f"training.n_devices={n_dev} on {avail} visible cards: multi-GPU "
                "training is ROADMAP.md queue 1 item 10")
        if n_dev > 1:
            self.logger.info(
                f"WARNING: training.n_devices={n_dev} requested but only {avail} "
                "device available — running on 1.  Global batch/LR semantics "
                "differ from the requested topology.")
        for key in TPU_ONLY_KEYS:
            if key in tcfg:
                self.logger.info(f"training.{key}={tcfg[key]!r} tunes the TPU or its "
                                 "host and is ignored")
        for key in ("log_images", "log_prototypes", "log_drift"):
            if tcfg.get(key):
                raise NotImplementedError(
                    f"training.{key} (media, prototype and drift logging) is ROADMAP.md "
                    "queue 1 item 14")
        if config.get("ood") is not None and self.use_bg_detector:
            raise NotImplementedError("the OOD dataset pass is ROADMAP.md queue 1 item 14")
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
        self.strict_restore = bool(tcfg.get("strict_restore", False))
        self._resume_epoch = -1
        self._skip_surgery = False

    # ------------------------------------------------------------------

    def _task_info(self, task_id: int) -> TaskInfo:
        dm = self.datamodule
        tcfg = self.config["training"]
        if self.continual:
            initial = int(tcfg.get("initial_increment", 0)) + 1  # + background
            inc = int(tcfg.get("increment", 0))
        else:
            initial = dm.num_classes
            inc = 0
        return TaskInfo(
            task_id=task_id, initial_classes=initial, increment=inc,
            num_classes=dm.num_classes, n_tasks=self.n_tasks,
            max_epochs=self._epochs_for(task_id), ignore_index=self.ignore_index,
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
        steps_epoch = -(-self.datamodule.steps_per_epoch() // self.accumulate)
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
            raise NotImplementedError(
                f"loading the pretrained backbone {bw_path} is ROADMAP.md queue 1 item 13")
        if bw_path:
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
        generator = torch.Generator(self.device)
        generator.manual_seed(self.seed)
        state = TrainState(
            model, *self._make_tx(task, model), generator=generator,
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
        ctx = ModelContext(task, fused_ce=self.fused_ce)
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
        self.state = self.method.begin_task(self.state, ctx, dm.train_batches(epoch=0))
        train_step, eval_step, put_batch = make_steps(ctx, self.method, dm.num_classes,
                                                      device=self.device)
        t_train = time.perf_counter()

        max_iters = self._max_iters(task) * self.accumulate  # mini-steps
        step_count = 0
        steps_epoch = dm.steps_per_epoch()
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
            for i, batch in enumerate(dm.train_batches(epoch=epoch)):
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
                if step_count <= 2 or step_count % 50 == 0:
                    self.logger.info(f"task {task_id} epoch {epoch} step {step_count} "
                                     f"loss {float(metrics['loss']):.4f}")
                if step_count > 2:
                    float(metrics["loss"])  # a host read, so the time is real
                    dt = time.perf_counter() - t0
                    if dt < 5.0:  # leave out first-call compilations
                        self._timing["images"] += batch["image"].shape[0]
                        self._timing["seconds"] += dt
                if (self.save_checkpoints and ckpt_every
                        and (i + 1) // ckpt_every > saved_chunks and (i + 1) < steps_epoch):
                    saved_chunks = (i + 1) // ckpt_every
                    checkpoint.save_task_checkpoint(self.ckpt_dir, task_id, self.state,
                                                    step=f"last{last_slot}")
                    last_slot = 1 - last_slot
                if step_count >= max_iters:
                    break
            # periodic validation on the current (and previous) task's val set
            # (reference: training.val_every; model.py:385 dual val loaders)
            val_every = int(self.config["training"].get("val_every", 0) or 0)
            if val_every and (epoch + 1) % val_every == 0 and epoch + 1 < self._epochs_for(task_id):
                self._run_validation(task_id, ctx, eval_step, put_batch, epoch)
            if self.save_checkpoints:
                checkpoint.save_task_checkpoint(self.ckpt_dir, task_id, self.state,
                                                step=f"last{last_slot}")
                last_slot = 1 - last_slot
            if step_count >= max_iters:
                break
        t_end = time.perf_counter()

        # buffers are populated from CANONICAL (non-augmented) images; replay
        # re-augments per step (reference: base_datamodule.py:433-451)
        self.state = self.method.end_task(self.state, ctx,
                                          dm.train_batches(epoch=0, augment=False))
        if self.save_checkpoints:
            checkpoint.save_task_checkpoint(self.ckpt_dir, task_id, self.state, "final")
        t_test = time.perf_counter()
        results = self._run_test(task_id, ctx, eval_step, put_batch)
        t_done = time.perf_counter()
        self.task_seconds.append({
            "boundary": t_train - t_start, "train": t_end - t_train,
            "end_task": t_test - t_end, "test": t_done - t_test, "wall": t_done - t_start})
        return results

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
        statistics) of task ``d``'s eval batches; the aux pair with ``ctx``."""
        dm = self.datamodule
        conf = torch.zeros((dm.num_classes, dm.num_classes), dtype=torch.int32,
                           device=self.device)
        conf_aux = torch.zeros((2, 2), dtype=torch.int32, device=self.device)
        losses, weights, aux_stats = [], [], []
        for batch in dm.eval_batches(d):
            # padded tail batches count only their real samples
            # (reference: PL batch-size weighting)
            weights.append(batch.pop("n_real"))
            batch = put_batch(batch)
            conf, loss = eval_step(self.state, conf, batch)
            losses.append(loss)
            if ctx is not None:
                conf_aux, stats = aux_bg_step(ctx, self.state, batch, conf_aux)
                aux_stats.append(stats)
        loss = float(np.average([float(v) for v in losses], weights=weights))
        return conf.cpu().numpy(), loss, conf_aux.cpu().numpy(), aux_stats

    def _run_validation(self, task_id, ctx, eval_step, put_batch, epoch):
        """Mid-training val pass: current task (+ previous task as `prev`)
        (reference: Model.validation_step, training/model.py:385-424)."""
        task = ctx.task
        targets = [("val", task_id)]
        if self.continual and task_id > 0:
            targets.append(("prev", task_id - 1))
        for prefix, t in targets:
            conf, loss, _, _ = self._eval_pass(t, eval_step, put_batch)
            metrics = detailed_iou_metrics(conf, initial_classes=task.initial_classes,
                                           nb_current_classes=task.nb_current_classes)
            self.logger.log_metrics({f"{prefix}/mIoU": metrics["mIoU"],
                                     f"{prefix}/loss": loss, f"{prefix}/epoch": epoch})

    def _run_test(self, task_id, ctx, eval_step, put_batch):
        """Eval over tasks 0..t (reference: trainer.py:371-383)."""
        dm = self.datamodule
        task = ctx.task
        results: List[Dict[str, float]] = []
        for d in dm.eval_task_range(task_id):
            conf, loss, conf_aux, aux_stats = self._eval_pass(
                d, eval_step, put_batch, ctx if self.use_bg_detector else None)
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
        return results

    # ------------------------------------------------------------------

    def _try_resume(self) -> int:
        """Restore the newest checkpoint; returns the first task to train
        (reference: trainer.py:254-268 task-indexed resume)."""
        if not self.resume_enabled:
            return 0
        found = checkpoint.latest_checkpoint(self.ckpt_dir)
        if not found:
            return 0
        t_ckpt, path = found
        is_final = path.endswith("final")
        # the template's schedule is the task's own: its step budget counts
        # the task's batches (the JAX loop rebuilds its optax chain per task)
        self.datamodule.set_task_id(t_ckpt)
        template = self._init_state(self._task_info(t_ckpt))
        if self.method.needs_prev_model and (t_ckpt > 0 or is_final):
            template.prev_model = frozen_copy(template.model)
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

    def fit(self) -> float:
        """The outer task loop (reference: trainer.py:415-433)."""
        start_task = self._try_resume()
        # metric keys are task-indexed; resumed runs start aggregating at the
        # resumed task (earlier tasks' historical metrics lived in the logs)
        self.per_step_metric.task_id = start_task
        for task_id in range(start_task, self.n_tasks):
            self.logger.info(
                f"=== task {task_id + 1}/{self.n_tasks} "
                f"(classes ≤ {self._task_info(task_id).nb_current_classes}) ===")
            results = self._run_task(task_id)
            self.per_step_metric.update(results)
        self._log_final_results()
        return self.per_step_metric.final_miou

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
