"""The port's two remaining entry points and ``training.profile_dir``, on the
CPU, without the reference checkout.

- ``bacs_tpu_torch.voc_runbook``: ``check_data`` passes on a VOC tree from
  ``scripts/gen_voc_layout.py`` and fails with JAX's messages on broken
  ones; ``check_backbone`` and ``check_convert`` pass on release files the
  port writes (seeded values over ``release_backbone_shapes``, and
  ``export_backbone_release`` of a network holding them) and refuse a bare
  state dict and another naming scheme; ``main`` without ``--smoke`` exits
  0 and prints the port's train command with ``backbone_weights_path``
  (as JAX's ``tests/test_voc_runbook.py:111-117`` asserts of JAX's), and
  exits 1 on a broken tree.  The release files are ResNet-18's, the
  smallest backbone the port builds; the ``--smoke`` fit runs on the card
  (``chip_smoke.py`` [44]).
- ``bacs_tpu_torch.make_pretrained_backbone`` at ResNet-18, 32² and 8
  images writes a file that JAX's ``load_pretrained_backbone`` and the
  port's ``load_backbone_into`` read to the same values.
- ``training.profile_dir``: one Chrome trace, of task 0's step loop only,
  and the run's losses and metrics equal a run without it.
- The two entry points and the host data path's modules import nothing of
  JAX or the JAX package.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from bacs_tpu_torch import make_pretrained_backbone, voc_runbook
from bacs_tpu_torch.models import create_network
from bacs_tpu_torch.utils import torch_weights as tw

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from scripts.gen_voc_layout import generate  # noqa: E402
from torch_port_helpers import _one_thread  # noqa: F401,E402

BACKBONE = "resnet18"


@pytest.fixture(scope="module")
def voc_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("voc"))
    generate(root, n_train=12, n_val=4, size=96)
    return root


@pytest.fixture(scope="module")
def release(tmp_path_factory):
    """Two ResNet-18 release files: seeded values over the release keys
    with the ImageNet fc the loader drops, and ``export_backbone_release``
    of a network that loaded the first."""
    base = tmp_path_factory.mktemp("release")
    net = create_network("deeplab", 21, backbone=BACKBONE)
    shapes = tw.release_backbone_shapes(tw.model_variables(net)["params"]["backbone"])
    sd = {f"module.{k}": v for k, v in tw.seeded_state_dict(shapes, 17).items()}
    sd["module.classifier.fc.weight"] = torch.zeros(1000, 512)
    sd["module.classifier.fc.bias"] = torch.zeros(1000)
    seeded = str(base / "resnet18_iabn_sync.pth.tar")
    torch.save({"state_dict": sd}, seeded)
    n = tw.load_backbone_into(net, seeded)
    exported = str(base / "exported.pth.tar")
    assert tw.export_backbone_release(tw.model_variables(net), exported) == n == len(shapes)
    return {"seeded": seeded, "exported": exported, "n": len(shapes)}


def test_check_data_passes_on_valid_tree(voc_root, capsys):
    assert voc_runbook.check_data(voc_root) == {"train": 12, "val": 4}
    assert "[ok]" in capsys.readouterr().out


def test_check_data_fails_actionably(tmp_path):
    with pytest.raises(voc_runbook.StageError, match="VOCtrainval"):
        voc_runbook.check_data(str(tmp_path))
    voc = tmp_path / "VOCdevkit" / "VOC2012" / "JPEGImages"
    voc.mkdir(parents=True)
    with pytest.raises(voc_runbook.StageError, match="SegmentationClassAug"):
        voc_runbook.check_data(str(tmp_path))
    (voc.parent / "SegmentationClassAug").mkdir()
    with pytest.raises(voc_runbook.StageError, match="train_aug.txt not found"):
        voc_runbook.check_data(str(tmp_path))


@pytest.mark.parametrize("which", ["seeded", "exported"])
def test_check_backbone_and_convert_pass_on_port_files(release, which):
    out = voc_runbook.check_backbone(release[which])
    assert out == {"n_tensors": release["n"] + 2, "n_fc": 2}
    conv = voc_runbook.check_convert(release[which], BACKBONE)
    assert conv["converted"] == conv["expected"] == release["n"]


def test_check_backbone_refuses_other_formats(tmp_path):
    bare = tmp_path / "bare.pth"
    torch.save({"conv1.weight": torch.zeros(2, 2)}, bare)
    with pytest.raises(voc_runbook.StageError, match="state_dict"):
        voc_runbook.check_backbone(str(bare))
    wrong = tmp_path / "wrong.pth.tar"
    torch.save({"state_dict": {"module.layer1.0.conv1.weight": torch.zeros(2, 2)}}, wrong)
    with pytest.raises(voc_runbook.StageError, match="mod1"):
        voc_runbook.check_backbone(str(wrong))


def test_runbook_main_end_to_end(voc_root, release, tmp_path, capsys):
    rc = voc_runbook.main(["--root", voc_root, "--backbone-ckpt", release["seeded"],
                           "--backbone", BACKBONE])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "bacs_tpu_torch.main" in out and "backbone_weights_path" in out
    assert "[4/4] train command" in out and "[FAIL]" not in out
    cmd = voc_runbook.train_command(voc_root, release["seeded"], smoke=True)
    assert cmd[1:3] == ["-m", "bacs_tpu_torch.main"] and "+training.debug=true" in cmd
    # the command's overrides load (JAX's `training.debug=true` is refused)
    from bacs_tpu_torch.config import load_config

    config = load_config("conf/bacs", "bacs_plus_config", cmd[7:])
    assert config["training"]["debug"] is True and config["training"]["mode"] == "overlap"
    assert voc_runbook.main(["--root", str(tmp_path), "--stage", "data"]) == 1
    assert "[FAIL]" in capsys.readouterr().out


def test_make_pretrained_backbone_reads_the_same_in_both_packages(tmp_path):
    from bacs_tpu.utils.torch_weights import load_pretrained_backbone

    out = str(tmp_path / "bb" / "rn18_rich.pth.tar")
    result = make_pretrained_backbone.main([
        "--out", out, "--backbone", BACKBONE, "--crop", "32", "--epochs", "1",
        "--n-train", "8", "--n-classes", "6", "--batch", "4", "--device", "cpu"])
    assert os.path.isfile(out) and result["n_tensors"] > 0
    assert np.isfinite(result["joint_miou"])
    net = create_network("deeplab", 21, backbone=BACKBONE)
    # JAX's loader onto a fresh network's Flax-shaped trees
    variables = tw.model_variables(net)
    assert tw.load_backbone_into(net, out) == result["n_tensors"]
    got = tw.model_variables(net)
    params, stats, n = load_pretrained_backbone(out, variables)
    assert n == result["n_tensors"]
    flat = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict) or hasattr(v, "items"):
                walk(v, prefix + (k,))
            else:
                flat[prefix + (k,)] = np.asarray(v)

    walk({"params": params["backbone"], "batch_stats": stats["backbone"]}, ())
    for (kind, *path), want in flat.items():
        node = got[kind]["backbone"]
        for p in path:
            node = node[p]
        assert np.array_equal(np.asarray(node, np.float32), want.astype(np.float32)), path
    # the pre-run moved the statistics off their initial values
    assert np.abs(got["batch_stats"]["backbone"]["bn1"]["mean"]).max() > 0


def _fit(profile_dir, monkeypatch):
    """conf/continual_debug (3 tasks) on the CPU; (the logged lines without
    their clock, the tasks whose step loop was profiled)."""
    from bacs_tpu_torch.config import load_config
    from bacs_tpu_torch.train import loop
    from bacs_tpu_torch.utils.logging import Logger

    lines, profiled = [], []
    monkeypatch.setattr(Logger, "info", lambda self, msg: lines.append(msg))
    start = getattr(loop.Trainer._start_profile, "__wrapped__", loop.Trainer._start_profile)

    def spy(self):
        profiled.append(self.datamodule.task_id)
        return start(self)

    spy.__wrapped__ = start
    monkeypatch.setattr(loop.Trainer, "_start_profile", spy)
    overrides = ["dataset.dataset.crop_size=32"]
    if profile_dir:
        overrides.append(f"+training.profile_dir={profile_dir}")
    loop.Trainer(load_config("conf/continual_debug", "config", overrides), device="cpu").fit()
    return [m for m in lines if "loss" in m or "mIoU" in m], profiled


def test_profile_dir_traces_task_zero_only(tmp_path, monkeypatch):
    plain, none = _fit(None, monkeypatch)
    traced, profiled = _fit(str(tmp_path / "prof"), monkeypatch)
    assert none == [] and profiled == [0]
    assert traced == plain and any("task 2" in m for m in plain)
    assert os.listdir(tmp_path / "prof") == ["trace.json"]
    with open(tmp_path / "prof" / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::convolution" in names


def test_profile_dir_stops_when_a_step_raises(tmp_path, monkeypatch):
    """A step of task 0 that raises still stops the profiler and writes its
    trace, so a caller that catches the error keeps no profiler running."""
    from bacs_tpu_torch.config import load_config
    from bacs_tpu_torch.train import loop

    make_steps = loop.make_steps

    def failing(*args, **kwargs):
        train_step, eval_step, put_batch = make_steps(*args, **kwargs)

        def boom(state, batch):
            raise RuntimeError("step failed")

        return boom, eval_step, put_batch

    monkeypatch.setattr(loop, "make_steps", failing)
    prof = tmp_path / "prof"
    config = load_config("conf/continual_debug", "config", [
        "dataset.dataset.crop_size=32", f"+training.profile_dir={prof}"])
    with pytest.raises(RuntimeError, match="step failed"):
        loop.Trainer(config, device="cpu").fit()
    assert not torch.autograd._profiler_enabled()
    assert os.listdir(prof) == ["trace.json"]


def test_new_entry_points_import_no_jax():
    """The runbook, the pre-run and the host data path's modules import
    nothing of JAX or the JAX package."""
    import subprocess

    code = ("import sys\n"
            "import bacs_tpu_torch.voc_runbook, bacs_tpu_torch.make_pretrained_backbone\n"
            "from bacs_tpu_torch.data import download, native, native_decode\n"
            "from bacs_tpu_torch.kernels import host_build\n"
            "assert native.available() and native_decode.available() in (True, False)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
            "             ('jax', 'jaxlib', 'flax', 'bacs_tpu'))\n"
            "assert not bad, bad\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], cwd=repo, capture_output=True, text=True)
    assert res.returncode == 0, res.stderr[-2000:]
