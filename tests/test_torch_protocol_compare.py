"""The port's protocol runner against ``scripts/protocol_compare.py``, on the CPU.

``bacs_tpu_torch.protocol_compare`` must run the legs of
``docs/RESULTS.md`` as the JAX script does: the same protocols, methods and
config overrides on ``conf/continual_debug`` for every protocol and method,
and the same command line.  Both sides' ``load_config`` and ``Trainer``
are replaced by recorders, so no training runs there.  Then one tiny leg
of ER and one of SDR train on the CPU (DeepLabV3-ResNet-18, crop 32, one
epoch a task), and an SDR state's class prototypes survive a checkpoint
and the Trainer's resume.
"""

import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

import bacs_tpu.config as jax_config
import bacs_tpu.train.loop as jax_loop
import bacs_tpu_torch.config as port_config
import bacs_tpu_torch.train.loop as port_loop
from bacs_tpu_torch import protocol_compare as port_pc
from bacs_tpu_torch.utils import checkpoint

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = {"method", "final_miou", "oldest_task_miou", "task0_miou", "avg_iou_per_dataset",
        "seconds"}


def jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_protocol_compare", os.path.join(ROOT, "scripts", "protocol_compare.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class FakeTrainer:
    """What ``run_method`` reads of a Trainer, without training."""

    def __init__(self, config, *args, **kwargs):
        self.per_step_metric = self
        self._per_step = {"mIoU": [[0.5], [0.25, 0.75]]}
        self.task_seconds, self.throughput = [], 0.0
        self.logger = port_loop.Logger()

    def fit(self):
        return 0.5

    def get_avg_iou(self):
        return np.array([0.5, 0.5])


@pytest.fixture
def recorded(monkeypatch):
    """Both runners' ``load_config`` and ``Trainer`` replaced: each call's
    overrides are recorded under "jax" or "port"."""
    calls = {"jax": [], "port": []}
    for side, cfg_mod, loop_mod in (("jax", jax_config, jax_loop),
                                    ("port", port_config, port_loop)):
        monkeypatch.setattr(cfg_mod, "load_config",
                            lambda path, name, overrides, side=side: calls[side].append(
                                (path, name, list(overrides))) or {})
        monkeypatch.setattr(loop_mod, "Trainer", FakeTrainer)
    return calls


def test_protocols_and_methods_match_the_script():
    script = jax_script()
    assert port_pc.PROTOCOLS == script.PROTOCOLS
    assert port_pc.METHOD_LOSS == script.METHOD_LOSS


@pytest.mark.parametrize("protocol", sorted(port_pc.PROTOCOLS))
def test_run_method_overrides_match_the_script(protocol, recorded):
    """For every method, on the protocol's network and on DeepLab with a
    crop and extra overrides: the same ``load_config`` call, and the same
    record keys and values from the same Trainer."""
    script = jax_script()
    p = script.PROTOCOLS[protocol]
    variants = [dict(network=p.get("net", "unet"), backbone=p.get("backbone", "resnet50")),
                dict(network="deeplab", backbone="resnet18", crop=32,
                     extra_overrides=("training.mode=disjoint", "+loss.lkd=0.5"))]
    for method in script.METHOD_LOSS:
        for kw in variants:
            ref = script.run_method(p, method, 7, **kw)
            got = port_pc.run_method(p, method, 7, device="cpu", **kw)
            assert recorded["port"][-1] == recorded["jax"][-1], (protocol, method, kw)
            assert recorded["port"][-1][:2] == ("conf/continual_debug", "config")
            ref.pop("seconds"), got.pop("seconds")
            assert got == ref
    assert len(recorded["port"]) == len(recorded["jax"]) == 2 * len(script.METHOD_LOSS)


@pytest.mark.parametrize("argv", [
    [],
    ["--protocol", "15-1-flagship", "--methods", "er,sdr,icarl"],
    ["--protocol", "15-1", "--network", "deeplab", "--backbone", "resnet101", "--crop", "128",
     "--methods", "ce,bacs", "--seed", "3", "--epochs", "2", "--cache", "none",
     "--mode", "disjoint", "--override", "+loss.boundary_train_mode=false"],
    ["--protocol", "ade-100-50", "--cache", "ram"],
])
def test_command_line_matches_the_script(argv, recorded, monkeypatch, capsys):
    """The same flags give the same legs (protocol, method, seed, network,
    backbone, crop, overrides), the same JSON lines and the same table."""
    script = jax_script()
    outputs = {}
    for side, mod, extra in (("jax", script, []), ("port", port_pc, ["--device", "cpu"])):
        monkeypatch.setattr(sys, "argv", ["protocol_compare"] + argv + extra)
        if side == "jax":
            import bacs_tpu.utils.cache as jax_cache
            monkeypatch.setattr(jax_cache, "enable_compilation_cache", lambda *a, **k: None)
            mod.main()
        else:
            mod.main(argv + extra)
        out = capsys.readouterr().out.splitlines()
        # the JSON lines, and the table (the port's log lines left out)
        outputs[side] = [json.loads(line) for line in out if line.startswith("{")], [
            line for line in out if not line.startswith(("{", "["))]
    assert recorded["port"] == recorded["jax"] and recorded["port"]
    for ref, got in zip(*(outputs[s][0] for s in ("jax", "port"))):
        assert set(got) == KEYS
        ref.pop("seconds"), got.pop("seconds")
        assert got == ref
    assert outputs["port"][1] == outputs["jax"][1]


@pytest.mark.parametrize("method", ["er", "sdr"])
def test_tiny_cpu_leg(method, capsys):
    """One leg on the CPU: the 3-task protocol on DeepLabV3-ResNet-18 at
    crop 32, one epoch a task (48 train and 16 validation images, every
    task's subset non-empty): one JSON line with the runner's keys, finite
    mIoUs in [0, 1], one Avg-IoU per task, then the table."""
    results = port_pc.main(["--protocol", "3task", "--network", "deeplab", "--backbone",
                            "resnet18", "--crop", "32", "--epochs", "1", "--methods",
                            method, "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    rec = json.loads(next(line for line in lines if line.startswith("{")))
    assert set(rec) == KEYS and rec == results[0] and rec["method"] == method
    assert len(rec["avg_iou_per_dataset"]) == 3
    for k in ("final_miou", "oldest_task_miou", "task0_miou"):
        assert 0.0 <= rec[k] <= 1.0, (k, rec)
    assert any(line.startswith(f"| {method} |") for line in lines)


def test_unet_protocol_raises():
    """A protocol on UNet raises where the network is built, naming the
    ROADMAP item."""
    with pytest.raises(NotImplementedError, match="item 12"):
        port_pc.main(["--protocol", "3task", "--methods", "ce", "--epochs", "1",
                      "--device", "cpu"])


def test_sdr_class_prototypes_survive_checkpoint_and_resume(tmp_path):
    """The Trainer builds SDR's class prototypes [C, D] and counts [C]; a
    state saved after a task keeps them, and a new Trainer's resume restores
    them bit for bit (with the previous model)."""
    p = port_pc.PROTOCOLS["3task"]
    overrides = port_pc.method_overrides(p, "sdr", 42, "deeplab", "resnet18", 32,
                                         (f"+training.ckpt_dir={tmp_path}",))
    config = port_config.load_config("conf/continual_debug", "config", overrides)
    trainer = port_loop.Trainer(config, device="cpu")
    trainer.datamodule.set_task_id(0)
    state = trainer._init_state(trainer._task_info(0))
    assert state.class_prototypes.shape == (p["n_classes"], 512)
    assert state.class_proto_counts.shape == (p["n_classes"],)
    assert not state.class_prototypes.any() and not state.class_proto_counts.any()
    gen = torch.Generator().manual_seed(0)
    state.class_prototypes = torch.rand(state.class_prototypes.shape, generator=gen)
    state.class_proto_counts = torch.randint(0, 50, (p["n_classes"],), generator=gen).float()
    state = trainer.method.end_task(state, port_loop.ModelContext(trainer._task_info(0)), [])
    checkpoint.save_task_checkpoint(str(tmp_path), 0, state, "final")

    resumed = port_loop.Trainer(config, device="cpu")
    assert resumed._try_resume() == 1
    assert torch.equal(resumed.state.class_prototypes, state.class_prototypes)
    assert torch.equal(resumed.state.class_proto_counts, state.class_proto_counts)
    assert resumed.state.prev_model is not None
    # a state without them (CE) saves and restores None
    ce = port_loop.Trainer(port_config.load_config(
        "conf/continual_debug", "config",
        port_pc.method_overrides(p, "ce", 42, "deeplab", "resnet18", 32)), device="cpu")
    ce_state = ce._init_state(ce._task_info(0))
    assert ce_state.class_prototypes is None
    path = checkpoint.save_task_checkpoint(str(tmp_path / "ce"), 0, ce_state, "final")
    assert checkpoint.restore_checkpoint(path, ce._init_state(ce._task_info(0))
                                         ).class_prototypes is None


def test_runner_defaults_to_the_card(monkeypatch):
    """Without ``--device`` a leg trains on the card, and raises where torch
    sees none; nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert port_pc.parse_args([]).device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_pc.main(["--protocol", "3task", "--network", "deeplab", "--methods", "er"])


def test_port_imports_no_jax():
    """Every module of the port and ``chip_smoke.py`` import without jax,
    flax, the JAX package or ``scripts``."""
    import subprocess

    code = (
        "import pkgutil, sys, importlib, bacs_tpu_torch\n"
        "for m in pkgutil.walk_packages(bacs_tpu_torch.__path__, 'bacs_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'bacs_tpu', 'scripts'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
