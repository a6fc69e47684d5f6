"""Serving a trained checkpoint, importing a reference checkpoint and the
pretrained backbone in the port's Trainer, on the CPU.

- Train ``conf/joint_debug`` (DeepLabV3-RN18, 64², 2 epochs) with
  checkpoints, then ``Predictor.from_checkpoint``: its masks equal the
  upsampled argmax of the Trainer's own eval forward on the same images;
  ``python -m bacs_tpu_torch.predict`` writes those masks (as
  ``tests/test_serve.py`` does for JAX), its ``--export`` writes a program
  that serves them, and ``--n-devices 2`` splits each batch.
- ``python -m bacs_tpu_torch.import_ckpt`` on a reference Lightning
  checkpoint (``network.``-prefixed keys from
  ``utils/torch_weights.py:reference_deeplab_shapes``, one classifier head
  of task 0's classes) writes task 0's ``final`` with every tensor loaded;
  ``python -m bacs_tpu_torch.main`` with that ``ckpt_dir`` resumes at task
  1 from the imported weights and trains to the end.  With
  ``--populate-buffer`` (BACS with the detector) the buffer holds images,
  and the checkpoint serves (the detector left out).
- A release backbone file at ``network.backbone_weights_path``: the
  Trainer's new network carries exactly the backbone JAX's
  ``load_pretrained_backbone`` makes of that file, and a missing file
  trains from the seeded weights.
"""

import os

import jax
import numpy as np
import pytest
import torch

from bacs_tpu.models import create_network as jax_create_network
from bacs_tpu.utils import torch_weights as jax_tw
from bacs_tpu_torch import import_ckpt, predict
from bacs_tpu_torch import main as cli
from bacs_tpu_torch.config import load_config
from bacs_tpu_torch.data.transforms import normalize_image
from bacs_tpu_torch.ops.upsample_argmax import upsampled_argmax_conf
from bacs_tpu_torch.serve import Predictor
from bacs_tpu_torch.train.loop import Trainer
from bacs_tpu_torch.utils import checkpoint
from bacs_tpu_torch.utils import torch_weights as tw
from bacs_tpu_torch.utils.logging import Logger
from torch_port_helpers import _one_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOINT = os.path.join(ROOT, "conf", "joint_debug")
CONT = os.path.join(ROOT, "conf", "continual_debug")
JOINT_OVERRIDES = ["network=deep_lab", "training.epochs=1", "training.val_every=0"]
CONT_OVERRIDES = ["network=deep_lab", "dataset.dataset.crop_size=32", "training.debug=false"]


@pytest.fixture
def logged(monkeypatch):
    lines = []
    monkeypatch.setattr(Logger, "info", lambda self, msg: lines.append(str(msg)))
    monkeypatch.setattr(Logger, "log_metrics", lambda self, m: None)
    return lines


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A joint_debug run with checkpoints: (config, ckpt_dir, trainer)."""
    ckpt = str(tmp_path_factory.mktemp("ckpt"))
    config = load_config(JOINT, "config", JOINT_OVERRIDES + [f"+training.ckpt_dir={ckpt}"])
    trainer = Trainer(config, device="cpu")
    trainer.fit()
    return config, ckpt, trainer


def val_images(trainer, n=4):
    src = trainer.datamodule.val_source
    return np.stack([src.load(i)[0] for i in range(n)])


def test_from_checkpoint_serves_the_trainers_model(trained):
    config, ckpt, trainer = trained
    assert checkpoint.latest_checkpoint(ckpt)[1].endswith("final")
    pred = Predictor.from_checkpoint(ckpt, config, device="cpu", dtype=torch.float32)
    assert pred.active_classes == trainer.datamodule.num_classes == 6
    images = val_images(trainer)
    masks, conf = pred.predict(images)
    model = trainer.state.model.eval()
    with torch.no_grad():
        sem = model.sem_logits(normalize_image(torch.from_numpy(images)))[..., :6]
        ref, ref_conf = upsampled_argmax_conf(sem.contiguous(), images.shape[1:3])
    assert masks.shape == images.shape[:3] and masks.dtype == np.uint8
    assert np.array_equal(masks, ref.numpy())
    np.testing.assert_array_equal(conf, ref_conf.numpy())
    # the restored weights are the trained ones
    for k, v in trainer.state.model.state_dict().items():
        assert torch.equal(pred.model.state_dict()[k], v), k


def test_from_checkpoint_of_another_device_type(trained, tmp_path):
    """A checkpoint written on the card before the draws were
    counter-based restores on the CPU: its CUDA generator's 16 bytes in
    place of a key are passed over, the template's key stays; the weights
    are restored."""
    config, ckpt, trainer = trained
    saved = torch.load(checkpoint.latest_checkpoint(ckpt)[1], weights_only=False)
    saved.pop("key")
    saved["generator"] = torch.zeros(16, dtype=torch.uint8)
    other = str(tmp_path / "card")
    os.makedirs(os.path.join(other, "step_0"))
    torch.save(saved, os.path.join(other, "step_0", "final"))
    pred = Predictor.from_checkpoint(other, config, device="cpu", dtype=torch.float32)
    for k, v in trainer.state.model.state_dict().items():
        assert torch.equal(pred.model.state_dict()[k], v), k


def test_predict_cli_writes_the_masks(trained, tmp_path):
    from PIL import Image

    config, ckpt, trainer = trained
    paths = []
    for i, img in enumerate(val_images(trainer, 3)):
        paths.append(str(tmp_path / f"img{i}.png"))
        Image.fromarray(img).save(paths[-1])
    out = str(tmp_path / "masks")
    args = ["--config-path", JOINT, "--config-name", "config", "--checkpoint", ckpt,
            "--device", "cpu", *JOINT_OVERRIDES]
    masks = predict.main(args + ["--images", *paths, "--out", out])
    assert sorted(os.listdir(out)) == [f"img{i}_mask.png" for i in range(3)]
    pred = Predictor.from_checkpoint(ckpt, config, device="cpu")
    ref = pred.predict_files(paths)
    assert all(np.array_equal(a, b) for a, b in zip(masks, ref))
    # --export writes the inference program (tests/test_torch_export.py)
    predict.main(args + ["--export", str(tmp_path / "x")])
    x = np.random.RandomState(0).randint(
        0, 256, (8, pred.crop_size, pred.crop_size, 3)).astype(np.uint8)
    np.testing.assert_array_equal(
        Predictor.run_exported(str(tmp_path / "x"), pred.variables, x)[0], pred.predict(x)[0])
    # --n-devices splits each batch over replicas (two CPU replicas here)
    split = predict.main(args + ["--images", *paths, "--out", str(tmp_path / "split"),
                                 "--n-devices", "2"])
    assert all(np.array_equal(a, b) for a, b in zip(split, ref))
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        Predictor.from_checkpoint(str(tmp_path / "none"), config, device="cpu")


def reference_ckpt(path, config, seed=11):
    """A reference Lightning checkpoint of task 0 (one head of 4 classes)."""
    trainer = Trainer(config, device="cpu")
    variables = tw.model_variables(trainer._make_model())
    shapes = tw.reference_deeplab_shapes(variables, [4])
    sd = tw.seeded_state_dict(shapes, seed)
    torch.save({"state_dict": {f"network.{k}": v for k, v in sd.items()}, "epoch": 3}, path)
    return sd


def test_import_then_resume_at_the_next_task(tmp_path, logged, monkeypatch):
    config = load_config(CONT, "config", CONT_OVERRIDES)
    ref = reference_ckpt(str(tmp_path / "final.ckpt"), config)
    out = str(tmp_path / "imported")
    task_id, loaded, total, path = import_ckpt.main(
        ["--ckpt", str(tmp_path / "final.ckpt"), "--config-path", CONT, "--config-name",
         "config", "--out", out, "--device", "cpu", *CONT_OVERRIDES])
    assert task_id == 0 and loaded == total == len(ref)
    assert path.endswith(os.path.join("step_0", "final"))
    saved = torch.load(path, weights_only=False)["model"]
    assert torch.equal(saved["backbone.conv1.weight"], ref["backbone.mod1.conv1.weight"])
    assert torch.equal(saved["classifier_head.weight"][:4], ref["classifier_head.0.weight"])

    seen = []
    restore = checkpoint.restore_checkpoint

    def recording(p, template):
        state = restore(p, template)
        seen.append((p, state.model.state_dict()["backbone.conv1.weight"].clone()))
        return state

    monkeypatch.setattr(checkpoint, "restore_checkpoint", recording)
    miou = cli.main(["--device", "cpu", "--config-path", CONT, "--config-name", "config",
                     *CONT_OVERRIDES, f"+training.ckpt_dir={out}"])
    assert np.isfinite(miou)
    assert seen and seen[0][0] == path
    assert torch.equal(seen[0][1], ref["backbone.mod1.conv1.weight"])
    assert any("resumed after completed task 0" in line for line in logged)
    tasks = [line for line in logged if line.startswith("=== task")]
    assert tasks and tasks[0].startswith("=== task 2/3")  # tasks 1 and 2 only


def test_import_populates_the_buffer(tmp_path, logged):
    overrides = CONT_OVERRIDES + ["loss=bacs", "training.bg_detector=true"]
    config = load_config(CONT, "config", overrides)
    trainer = Trainer(config, device="cpu")
    variables = tw.model_variables(trainer._make_model())
    sd = tw.seeded_state_dict(tw.reference_deeplab_shapes(variables, [4]), 5)
    torch.save(sd, str(tmp_path / "bare.pt"))  # a bare state dict, no Lightning wrapper
    state, task_id, loaded, total, _ = import_ckpt.import_reference_checkpoint(
        str(tmp_path / "bare.pt"), config, str(tmp_path / "out"), populate_buffer=True,
        device="cpu")
    assert task_id == 0 and loaded == total
    assert state.prev_model is not None
    assert state.buffer.num_seen > 0 and bool(state.buffer.valid.any())
    assert float(state.proto_counts[0]) > 0
    # a checkpoint of a network with the detector serves without it
    pred = Predictor.from_checkpoint(str(tmp_path / "out"), config, device="cpu")
    assert not hasattr(pred.model, "seen_fg_network") or pred.model.seen_fg_network is None
    masks, _ = pred.predict(np.zeros((2, 32, 32, 3), np.uint8))
    assert masks.shape == (2, 32, 32) and int(masks.max()) < 4


def jax_release(path):
    """JAX's export of a seeded RN18 backbone, and JAX's initial variables."""
    m = jax_create_network("deeplab", 6, axis_name=None, backbone="resnet18")
    v = m.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
               np.zeros((1, 32, 32, 3), np.float32), train=False)
    rs = np.random.RandomState(4)
    noisy = jax.tree.map(lambda a: np.asarray(a) * rs.uniform(-1.5, 1.5, a.shape).astype(
        np.float32), v["params"])
    jax_tw.export_backbone_release({"params": noisy, "batch_stats": v["batch_stats"]}, path)
    return v


def test_trainer_loads_a_present_backbone_file(tmp_path, logged):
    path = str(tmp_path / "resnet18_iabn_sync.pth.tar")
    v = jax_release(path)
    r_params, r_stats, r_n = jax_tw.load_pretrained_backbone(path, v)
    config = load_config(CONT, "config",
                         CONT_OVERRIDES + [f"+network.backbone_weights_path={path}"])
    trainer = Trainer(config, device="cpu")
    state = trainer._init_state(trainer._task_info(0))
    assert f"loaded {r_n} pretrained backbone tensors from {path}" in logged
    got = tw.model_variables(state.model)
    for tree, ref in ((got["params"]["backbone"], r_params["backbone"]),
                      (got["batch_stats"]["backbone"], r_stats["backbone"])):
        flat = dict(jax.tree_util.tree_flatten_with_path(ref)[0])
        for kp, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            assert np.array_equal(np.asarray(leaf), np.asarray(flat[kp])), kp
    # a missing file trains from the seeded weights, as in JAX
    config = load_config(CONT, "config", CONT_OVERRIDES + [
        f"+network.backbone_weights_path={tmp_path / 'missing.pth.tar'}"])
    trainer = Trainer(config, device="cpu")
    trainer._init_state(trainer._task_info(0))
    assert any("not found; training from scratch" in line for line in logged)
