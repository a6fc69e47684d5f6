"""The OOD pass and the media, prototype and drift loggers against the JAX
package, on the CPU.

The network is DeepLabV3-ResNet-18 with the background detector (6 task
heads, VOC-21 split 16 + 1, task 1 in use) at 64^2, the configured leaky
ABN, in float32, from the same Flax variables (norm vectors redrawn by
``randomize_abn``), on seeded normalized images and labels, with seeded
prototypes.  Only eval-mode forwards run, which agree to f32 rounding.

- ``ood_test`` over three batches of 2: the unseen and seen pixel counts
  equal, except that a pixel whose seen-probability lies within
  ``TIE`` (1e-6) of the 0.5 threshold may fall on either side (the test
  prints the smallest margin); F1, accuracy and the mean within 1e-5.
- ``DriftProbe``: the snapshot's drift on changed weights within 1e-5 of
  JAX's, None off its cadence, 0 on unchanged weights.
- ``PrototypeLogger.collect`` over 2 of 3 batches: counts equal, class
  means within 1e-5; ``plot`` writes both PNGs.
- ``MediaLogger``: the collage PNG byte-equal to JAX's for the same arrays,
  and ``log_wandb``'s payload equal to JAX's with a fake wandb
  (``tests/test_domain_viz_ood.py:56``).
- The Trainer: ``conf/continual_debug`` on DeepLabV3-RN18 at 32^2, CE with
  the detector, two tasks (3 + 2 classes), an ``ood`` synthetic dataset
  and the three flags on, both packages on the smooth network (identity
  ABN) with the detector's dropout at rate 0, from JAX's initial weights
  with the eval transform for training (``tests/test_torch_loop.py``
  explains each): the same ``test.0_aux_ood/*`` and
  ``representation_drift`` keys, each value within ``TRAINER_TOL`` 1e-4
  (measured: the counts equal, the means and drifts within 1e-7), and the
  same file names written.
- Two gloo ranks, each on its half of every batch: the OOD metrics and the
  prototype means of one process on the whole batches, and the Trainer's
  gather of the media and drift samples (``_global_batch``) the whole
  first batch on each rank.

JAX is imported inside the reference functions: the ranks import this
module and need none of it.
"""

import functools
import os
import types
from unittest import mock

import numpy as np
import pytest
import torch

from bacs_tpu_torch import parallel
from bacs_tpu_torch.methods.base import ModelContext
from bacs_tpu_torch.models.deeplab import DeepLabV3
from bacs_tpu_torch.train.ood import ood_test
from bacs_tpu_torch.train.state import TaskInfo
from bacs_tpu_torch.utils.flax_weights import load_flax_variables
from bacs_tpu_torch.viz.drift import DriftProbe
from bacs_tpu_torch.viz.media import MediaLogger
from bacs_tpu_torch.viz.prototypes_viz import PrototypeLogger
from torch_port_helpers import _one_thread, randomize_abn  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CROP, BATCH, N_CLASSES, N_TASKS, D = 64, 2, 21, 6, 128
TASK = dict(task_id=1, initial_classes=16, increment=1, num_classes=N_CLASSES,
            n_tasks=N_TASKS)
TIE, TOL, TRAINER_TOL = 1e-6, 1e-5, 1e-4


@functools.lru_cache(maxsize=None)
def flax_variables(seed=11):
    import jax

    x = np.zeros((1, CROP, CROP, 3), np.float32)
    v = jax.jit(lambda k, x: jax_model().init(k, x, train=False))(jax.random.PRNGKey(0), x)
    rs = np.random.RandomState(seed)
    return randomize_abn(v["params"], rs), randomize_abn(v["batch_stats"], rs)


def jax_model():
    from bacs_tpu.models.deeplab import DeepLabV3 as JaxDeepLabV3

    return JaxDeepLabV3(num_classes=N_CLASSES, backbone_name="resnet18", n_tasks=N_TASKS,
                        use_bg_detector=True)


@functools.lru_cache(maxsize=None)
def inputs():
    """Three batches of normalized images and labels, and the prototypes."""
    rs = np.random.RandomState(5)
    batches = []
    for _ in range(3):
        lab = rs.randint(0, 17, (BATCH, CROP, CROP)).astype(np.int32)
        lab[rs.rand(*lab.shape) < 0.4] = 0
        lab[rs.rand(*lab.shape) < 0.05] = 255
        batches.append({"image": rs.randn(BATCH, CROP, CROP, 3).astype(np.float32),
                        "label": lab})
    return batches, (rs.randn(N_TASKS, D) * 0.5).astype(np.float32)


def port_state(variables, protos):
    model = DeepLabV3(N_CLASSES, backbone_name="resnet18", n_tasks=N_TASKS,
                      use_bg_detector=True)
    load_flax_variables(model, *variables)
    return types.SimpleNamespace(model=model.eval(), prototypes=torch.from_numpy(protos))


def port_batches(batches, rows=None):
    lo, hi = rows or (0, BATCH)
    return [{k: torch.from_numpy(v[lo:hi]) for k, v in b.items()} for b in batches]


def jax_state(variables, protos):
    import jax
    import jax.numpy as jnp

    from bacs_tpu.methods.base import ModelContext as JaxModelContext
    from bacs_tpu.train.state import TaskInfo as JaxTaskInfo
    from bacs_tpu.train.state import TrainState as JaxTrainState

    params, stats = variables
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                          opt_state=None, rng=jax.random.PRNGKey(2),
                          prototypes=jnp.asarray(protos), proto_counts=jnp.ones((N_TASKS,)))
    return JaxModelContext(jax_model(), JaxTaskInfo(**TASK), None), state


def perturbed(variables, seed=3):
    """The Flax variables with every parameter scaled by 1 +- 5 %."""
    import jax

    rs = np.random.RandomState(seed)
    params = jax.tree.map(lambda a: np.asarray(a) * rs.uniform(0.95, 1.05, np.shape(a))
                          .astype(np.float32), variables[0])
    return params, variables[1]


def test_ood_test_matches_jax():
    from bacs_tpu.train.ood import ood_test as jax_ood_test

    batches, protos = inputs()
    ref = jax_ood_test(*jax_state(flax_variables(), protos), iter(batches))
    state = port_state(flax_variables(), protos)
    ctx = ModelContext(TaskInfo(**TASK))
    got = ood_test(ctx, state, port_batches(batches))
    assert got.keys() == ref.keys()
    total = 3 * BATCH * CROP * CROP
    with torch.no_grad():
        margin = min(float((state.model.seen_probs(
            state.model(b["image"]).penultimate, state.prototypes, 2)[..., -1] - 0.5)
            .abs().min()) for b in port_batches(batches))
    print(f"smallest |seen-probability - 0.5|: {margin:.3g}; accuracy {got['Accuracy_current']}")
    tp, ref_tp = (round(m["Accuracy_current"] * total) for m in (got, ref))
    assert tp == ref_tp or margin < TIE, (tp, ref_tp, margin)
    assert 0 < tp < total  # both sides of the threshold are reached
    for k in ref:
        assert abs(got[k] - ref[k]) <= TOL, (k, got[k], ref[k])


def test_drift_probe_matches_jax():
    from bacs_tpu.viz.drift import DriftProbe as JaxDriftProbe

    batches, protos = inputs()
    ctx = ModelContext(TaskInfo(**TASK))
    jctx, jstate = jax_state(flax_variables(), protos)
    _, jstate_b = jax_state(perturbed(flax_variables()), protos)
    ref = JaxDriftProbe(max_samples=2, measure_every=5)
    ref.snapshot(jctx, jstate, batches[0])
    probe = DriftProbe(max_samples=2, measure_every=5)
    state = port_state(flax_variables(), protos)
    probe.snapshot(ctx, state, port_batches(batches)[0])
    assert probe.measure(ctx, state, 3) is None
    assert probe.measure(ctx, state, 5) == 0.0
    got = probe.measure(ctx, port_state(perturbed(flax_variables()), protos), 10)
    want = ref.measure(jctx, jstate_b, 10)
    assert want > 1e-3 and abs(got - want) <= TOL, (got, want)


def test_prototype_logger_matches_jax(tmp_path):
    from bacs_tpu.viz.prototypes_viz import PrototypeLogger as JaxPrototypeLogger

    batches, protos = inputs()
    ref = JaxPrototypeLogger(str(tmp_path / "jax"), max_batches=2).collect(
        *jax_state(flax_variables(), protos), iter(batches))
    logger = PrototypeLogger(str(tmp_path / "port"), max_batches=2)
    state = port_state(flax_variables(), protos)
    ctx = ModelContext(TaskInfo(**TASK))
    got = logger.collect(ctx, state, port_batches(batches))
    np.testing.assert_array_equal(got["counts"], np.asarray(ref["counts"]))
    assert (got["counts"] > 0).sum() >= 10
    scale = np.abs(ref["class_means"]).max()
    np.testing.assert_allclose(got["class_means"], ref["class_means"], rtol=0,
                               atol=TOL * scale)
    paths = logger.plot(ctx, state, got, task_id=1)
    assert sorted(os.path.basename(p) for p in paths) == ["proto_dist_task1.png",
                                                          "tsne_task1.png"]
    assert all(os.path.getsize(p) > 0 for p in paths)


class FakeWandb:
    def __init__(self):
        self.images, self.logged = [], {}

    def Image(self, img, masks=None):
        self.images.append((np.asarray(img), masks))
        return ("img", len(self.images) - 1)

    def log(self, payload, commit=True):
        assert commit is False
        self.logged.update(payload)


def test_media_logger_matches_jax(tmp_path):
    from bacs_tpu.data.transforms import normalize_image as jax_normalize
    from bacs_tpu.viz.media import MediaLogger as JaxMediaLogger

    rs = np.random.RandomState(8)
    image = np.asarray(jax_normalize(rs.randint(0, 256, (3, 16, 24, 3)).astype(np.uint8)))
    label = rs.randint(0, 21, (3, 16, 24)).astype(np.int32)
    label[0, :4] = 255
    pred = rs.randint(0, 21, (3, 16, 24)).astype(np.int64)
    ref, got = JaxMediaLogger(str(tmp_path / "jax")), MediaLogger(str(tmp_path / "port"))
    ref.append("test", image, label, pred)
    got.append("test", torch.from_numpy(image), torch.from_numpy(label), torch.from_numpy(pred))
    ref_path, path = ref.flush(2), got.flush(2)
    assert os.path.basename(path) == os.path.basename(ref_path) == "task2_test.png"
    with open(path, "rb") as f, open(ref_path, "rb") as g:
        assert f.read() == g.read()
    names = ["background"] + [f"c{i}" for i in range(1, 21)]
    loggers = [types.SimpleNamespace(_wandb=FakeWandb()) for _ in range(2)]
    ref.log_wandb(loggers[0], task_id=2, class_names=names)
    got.log_wandb(loggers[1], task_id=2, class_names=names)
    (want, have) = (lg._wandb for lg in loggers)
    assert have.logged == want.logged and list(have.logged) == ["Test/Task 2/Predictions"]
    assert len(have.images) == len(want.images) == 3
    for (img, masks), (ref_img, ref_masks) in zip(have.images, want.images):
        np.testing.assert_array_equal(img, ref_img)
        assert masks.keys() == ref_masks.keys() == {"predictions", "groud_truth"}
        for k in masks:
            np.testing.assert_array_equal(masks[k]["mask_data"], ref_masks[k]["mask_data"])
            assert masks[k]["class_labels"] == ref_masks[k]["class_labels"]
    got.log_wandb(object(), task_id=0)  # no wandb: nothing


# ---------------------------------------------------------------- the Trainer

CONF = os.path.join(ROOT, "conf", "continual_debug")
TRAINER_OVERRIDES = [
    "network=deep_lab", "dataset.dataset.crop_size=32", "training.batch_size=3",
    "training.bg_detector=true", "training.increment=2", "+training.log_images=true",
    "+training.log_prototypes=true", "+training.log_drift=true",
    "+training.drift_measure_every=1", "+ood._target_=dataloaders.SyntheticDataModule",
    "+ood.dataset.num_classes=6", "+ood.dataset.crop_size=32", "+ood.dataset.n_train=6",
    "+ood.dataset.n_val=9"]


def _smooth(models_mod, deeplab_mod, stack):
    """Every ABN with the identity activation, and the detector's dropout
    (drawn from each package's own generator) at rate 0."""
    make_norm = models_mod.make_norm
    stack.enter_context(mock.patch.object(
        models_mod, "make_norm",
        lambda *a, **k: functools.partial(make_norm(*a, **k), activation="identity")))
    stack.enter_context(mock.patch.object(
        deeplab_mod, "BgDetector", functools.partial(deeplab_mod.BgDetector, dropout_rate=0.0)))


def jax_trainer_run(media_dir):
    import contextlib

    import jax

    import bacs_tpu.models as jax_models
    import bacs_tpu.models.deeplab as jax_deeplab
    from bacs_tpu.config import load_config as jax_load_config
    from bacs_tpu.data import transforms as jax_transforms
    from bacs_tpu.train import loop as jax_loop
    from bacs_tpu.utils.logging import Logger as JaxLogger

    metrics = []
    config = jax_load_config(CONF, "config", TRAINER_OVERRIDES
                             + [f"+training.media_dir={media_dir}"])
    with contextlib.ExitStack() as stack:
        _smooth(jax_models, jax_deeplab, stack)
        stack.enter_context(mock.patch.object(
            JaxLogger, "log_metrics", lambda self, m: metrics.append(dict(m))))
        stack.enter_context(mock.patch.object(
            jax_transforms, "train_transform",
            lambda rng, imgs, lbls, table, crop=512, scale=None:
            jax_transforms.eval_transform(imgs, lbls, table, crop=crop)))
        trainer = jax_loop.Trainer(config)
        task = trainer._task_info(0)
        init = trainer._init_state(trainer._make_model(task), trainer._make_tx(task), task)
        variables = (jax.tree.map(np.asarray, init.params),
                     jax.tree.map(np.asarray, init.batch_stats))
        trainer.fit()
    return metrics, variables


def port_trainer_run(media_dir, variables):
    import contextlib

    import bacs_tpu_torch.models as port_models
    import bacs_tpu_torch.models.deeplab as port_deeplab
    from bacs_tpu_torch.config import load_config
    from bacs_tpu_torch.data import transforms
    from bacs_tpu_torch.train import loop
    from bacs_tpu_torch.utils.logging import Logger

    metrics = []
    config = load_config(CONF, "config", TRAINER_OVERRIDES + [f"+training.media_dir={media_dir}"])
    with contextlib.ExitStack() as stack:
        _smooth(port_models, port_deeplab, stack)
        stack.enter_context(mock.patch.object(
            Logger, "log_metrics", lambda self, m: metrics.append(dict(m))))
        stack.enter_context(mock.patch.object(
            transforms, "train_transform",
            lambda gen, imgs, lbls, table, crop=512, scale=None:
            transforms.eval_transform(imgs, lbls, table, crop=crop)))
        stack.enter_context(mock.patch.object(
            loop, "init_weights", lambda model, seed: load_flax_variables(model, *variables)))
        loop.Trainer(config, device="cpu").fit()
    return metrics


def callback_metrics(metrics):
    return [(k, v) for m in metrics for k, v in m.items()
            if k.startswith("test.0_aux_ood/") or k == "representation_drift"]


def test_trainer_callbacks_match_jax(tmp_path):
    ref, variables = jax_trainer_run(str(tmp_path / "jax"))
    got = port_trainer_run(str(tmp_path / "port"), variables)
    ref_cb, got_cb = callback_metrics(ref), callback_metrics(got)
    assert [k for k, _ in got_cb] == [k for k, _ in ref_cb]
    assert sum(k == "representation_drift" for k, _ in got_cb) == 2  # task 1's two steps
    assert sum(k.startswith("test.0_aux_ood/") for k, _ in got_cb) == 6
    for (k, v), (_, w) in zip(got_cb, ref_cb):
        assert abs(v - w) <= TRAINER_TOL, (k, v, w)
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
    assert len(os.listdir(tmp_path / "port")) == 6  # 2 tasks x (collage, t-SNE, distances)


# ------------------------------------------------------------- two gloo ranks


def rank_ood_protos(group, device, variables, batches, protos):
    from bacs_tpu_torch.train.loop import Trainer

    world, rank = parallel.world_size(group), parallel.rank(group)
    state = port_state(variables, protos)
    ctx = ModelContext(TaskInfo(**TASK), group=group)
    sliced = port_batches(batches, parallel.rank_rows(BATCH, world, rank))
    # the Trainer's gather of the media and drift samples from the slices
    trainer = types.SimpleNamespace(group=group, n_devices=world, rank=rank)
    gathered = Trainer._global_batch(trainer, sliced[0])
    return (ood_test(ctx, state, sliced),
            PrototypeLogger("unused", max_batches=2).collect(ctx, state, sliced),
            {k: v.numpy() for k, v in gathered.items()})


@pytest.fixture(scope="module")
def ranks():
    batches, protos = inputs()
    return parallel.spawn(rank_ood_protos, 2, (flax_variables(), batches, protos), threads=1)


def test_two_ranks_match_one_process(ranks):
    batches, protos = inputs()
    state = port_state(flax_variables(), protos)
    ctx = ModelContext(TaskInfo(**TASK))
    ref = ood_test(ctx, state, port_batches(batches))
    ref_protos = PrototypeLogger("unused", max_batches=2).collect(ctx, state,
                                                                 port_batches(batches))
    for metrics, collected, gathered in ranks:
        for k in ("image", "label"):
            np.testing.assert_array_equal(gathered[k], batches[0][k])
        assert metrics["Accuracy_current"] == ref["Accuracy_current"]
        for k in ref:
            assert abs(metrics[k] - ref[k]) <= 1e-6, (k, metrics[k], ref[k])
        np.testing.assert_array_equal(collected["counts"], ref_protos["counts"])
        np.testing.assert_allclose(collected["class_means"], ref_protos["class_means"],
                                   rtol=0, atol=TOL)
