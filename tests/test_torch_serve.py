"""The serving slice: the port's Predictor against the JAX Predictor.

Both run on the CPU from the same Flax trees (randomised ABN vectors) and
the same uint8 images; the port runs in float32 with its plain versions.
"""

import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bacs_tpu.models import create_network as jax_create_network
from bacs_tpu.serve import Predictor as JaxPredictor
from bacs_tpu_torch.serve import Predictor
from torch_port_helpers import randomize_abn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CROP = 64
NUM_CLASSES = 21
CFG = {"_target_": "networks.DeepLabV3", "norm": "iabn_sync",
       "backbone": "resnet18", "output_stride": 16}


@functools.lru_cache(maxsize=None)
def trees():
    m = jax_create_network("networks.DeepLabV3", num_classes=NUM_CLASSES,
                           axis_name=None, backbone="resnet18")
    x = np.zeros((1, CROP, CROP, 3), np.float32)
    v = jax.jit(lambda k, x: m.init(k, x, train=False))(jax.random.PRNGKey(1), x)
    rs = np.random.RandomState(11)
    return randomize_abn(v["params"], rs), randomize_abn(v["batch_stats"], rs)


def images(seed, n=2):
    return np.random.RandomState(seed).randint(
        0, 256, (n, CROP, CROP, 3)).astype(np.uint8)


def port(**kw):
    params, stats = trees()
    return Predictor(CFG, NUM_CLASSES, params, stats, crop_size=CROP,
                     dtype=torch.float32, device="cpu", **kw)


def reference(**kw):
    params, stats = trees()
    return JaxPredictor(CFG, NUM_CLASSES, params, stats, crop_size=CROP,
                        dtype=jnp.float32, **kw)


@pytest.mark.parametrize(
    "conf_dtype,pack_masks,active",
    [("float16", False, None), ("uint8", False, None), ("none", True, None),
     ("float16", True, 16)],
    ids=["f16", "u8", "none-packed", "f16-packed-16of21"],
)
def test_predictor_matches_jax(conf_dtype, pack_masks, active):
    kw = dict(conf_dtype=conf_dtype, pack_masks=pack_masks, active_classes=active)
    imgs = images(0)
    ref_p, ref_c = reference(**kw).predict(imgs)
    got_p, got_c = port(**kw).predict(imgs)
    assert got_p.dtype == np.uint8 and got_p.shape == (2, CROP, CROP)
    assert got_p.max() < (active or NUM_CLASSES)
    assert (got_p == np.asarray(ref_p)).mean() >= 0.999
    if conf_dtype == "none":
        assert got_c is None and ref_c is None
        return
    assert got_c.dtype == np.asarray(ref_c).dtype
    atol = 2e-3 if conf_dtype == "float16" else 1.0  # uint8: one 1/255 step
    np.testing.assert_allclose(got_c.astype(np.float32),
                               np.asarray(ref_c).astype(np.float32), atol=atol)


def test_predict_many_equals_predict():
    p = port(conf_dtype="uint8", pack_masks=True)
    batches = [images(1), images(2, n=1), images(3)]
    many = list(p.predict_many(iter(batches)))
    assert len(many) == 3
    for b, (preds, conf) in zip(batches, many):
        one_p, one_c = p.predict(b)
        np.testing.assert_array_equal(preds, one_p)
        np.testing.assert_array_equal(conf, one_c)


def test_predict_files_writes_masks(tmp_path):
    from PIL import Image

    paths = []
    for i, img in enumerate(images(4, n=3)):
        path = tmp_path / f"img{i}.png"
        Image.fromarray(img).save(path)
        paths.append(str(path))
    out_dir = tmp_path / "masks"
    masks = port().predict_files(paths, out_dir=str(out_dir), batch_size=2)
    assert len(masks) == 3 and masks[0].shape == (CROP, CROP)
    assert sorted(os.listdir(out_dir)) == [f"img{i}_mask.png" for i in range(3)]


def test_serving_path_imports_no_jax():
    code = (
        "import sys, numpy as np, torch\n"
        "from bacs_tpu_torch.models import create_network\n"
        "from bacs_tpu_torch.serve import Predictor\n"
        "from bacs_tpu_torch.utils.flax_weights import state_dict_to_flax\n"
        "torch.manual_seed(0)\n"
        "m = create_network('deeplab', 4, backbone='resnet18')\n"
        "params, stats = state_dict_to_flax(m.state_dict())\n"
        "p = Predictor({'backbone': 'resnet18'}, 4, params, stats, crop_size=32,\n"
        "              dtype=torch.float32, device='cpu')\n"
        "preds, conf = p.predict(np.zeros((1, 32, 32, 3), np.uint8))\n"
        "assert preds.shape == (1, 32, 32) and conf.shape == (1, 32, 32)\n"
        "from bacs_tpu_torch.methods import ModelContext, create_method\n"
        "from bacs_tpu_torch.train.optim import make_optimizer, poly_schedule\n"
        "from bacs_tpu_torch.train.state import TaskInfo, TrainState\n"
        "from bacs_tpu_torch.train.step import make_steps\n"
        "import bacs_tpu_torch.ops.confusion, bacs_tpu_torch.ops.losses\n"
        "opt, sch = make_optimizer({'momentum': 0.9, 'nesterov': True},\n"
        "                          m.parameters(), poly_schedule(0.01, 10))\n"
        "ctx = ModelContext(TaskInfo(num_classes=4))\n"
        "tr, ev, put = make_steps(ctx, create_method('loss.CrossEntropy'), 4,\n"
        "                         device='cpu')\n"
        "b = put({'image': np.zeros((2, 32, 32, 3), np.float32),\n"
        "         'label': np.ones((2, 32, 32), np.int32)})\n"
        "state, metrics = tr(TrainState(m, opt, sch), b)\n"
        "cm, loss = ev(state, torch.zeros((4, 4), dtype=torch.int32), b)\n"
        "assert int(cm.sum()) == 2 * 32 * 32\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'bacs_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_cuda_request_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params, stats = trees()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Predictor(CFG, NUM_CLASSES, params, stats, crop_size=CROP, device="cuda")


def test_unported_entry_points_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port(n_devices=2)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port().export("unused.bin")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Predictor.from_checkpoint("unused", None)
    with pytest.raises(ValueError, match="conf_dtype"):
        port(conf_dtype="bf16")
