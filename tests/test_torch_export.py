"""The exported serving program: ``Predictor.export`` and ``run_exported``
against the port's ``predict`` and the JAX package's export, on the CPU.

JAX's three round trips (``tests/test_serve.py:141-165``): the plain
Predictor, a two-replica one (JAX: a 2-device mesh of the conftest's
virtual CPU devices; the port: ``devices=["cpu", "cpu"]``; each exports the
single-device function) and the packed wire format (masks bit-packed, no
confidence).  Each runs on UNet-3 at 16^2, JAX's network there, and on
DeepLabV3-ResNet-18 at 64^2, from the same Flax variables (norm vectors
redrawn by ``randomize_abn``), in float32, on seeded uint8 images.

Tolerances: the port's exported program against its own single-device
``predict`` at the same batch is bit-equal (the same ops and the same
plain versions on the CPU).  Against
JAX's exported program the masks agree on at least 99.9 % of the pixels
(a top-2 tie within rounding may flip) and the f16 confidence within
2e-3, as ``tests/test_torch_serve.py`` holds the two Predictors.

Also: the graph keeps the serving kernels as the registered ops (one
``bacs::upsample_argmax_conf``, one ``bacs::abn_eval`` per ABN layer), so
that on the card the loaded program launches them; a program exported
with weights A serves weights B; a fresh process that imports only
``bacs_tpu_torch.serve`` loads and runs the file (and one that has not
imported it cannot load it), importing nothing of JAX; and ``python -m
bacs_tpu_torch.predict --device cpu --export`` on a trained checkpoint
writes a file that ``run_exported`` serves.
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
from bacs_tpu_torch.config import load_config
from bacs_tpu_torch.models.norm import ABN
from bacs_tpu_torch.ops.bitpack import unpack_bits
from bacs_tpu_torch.serve import Predictor
from bacs_tpu_torch.train.loop import Trainer
from torch_port_helpers import _one_thread, randomize_abn  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOINT = os.path.join(ROOT, "conf", "joint_debug")
NETS = {
    "unet3-16": ({"_target_": "networks.UNet", "num_layers": 3}, 4, 16),
    "deeplab-rn18-64": ({"_target_": "networks.DeepLabV3", "norm": "iabn_sync",
                         "backbone": "resnet18", "output_stride": 16}, 21, 64),
}
# (the port's Predictor options, the JAX Predictor's)
CASES = {
    "plain": ({}, {}),
    "two-replicas": ({"devices": ["cpu", "cpu"]}, {"n_devices": 2}),
    "packed": ({"conf_dtype": "none", "pack_masks": True},
               {"conf_dtype": "none", "pack_masks": True}),
}
MASK_AGREEMENT, CONF_ATOL = 0.999, 2e-3
K10 = "bacs.upsample_argmax_conf"
K5 = "bacs.abn_eval"


@functools.lru_cache(maxsize=None)
def trees(net, seed=11):
    cfg, classes, crop = NETS[net]
    kw = {k: v for k, v in cfg.items() if k != "_target_"}
    m = jax_create_network(cfg["_target_"], num_classes=classes, axis_name=None,
                           crop_size=crop, **kw)
    x = np.zeros((1, crop, crop, 3), np.float32)
    v = jax.jit(lambda k, x: m.init(k, x, train=False))(jax.random.PRNGKey(1), x)
    rs = np.random.RandomState(seed)
    return randomize_abn(v["params"], rs), randomize_abn(v["batch_stats"], rs)


def images(net, seed=0, n=2):
    crop = NETS[net][2]
    return np.random.RandomState(seed).randint(0, 256, (n, crop, crop, 3)).astype(np.uint8)


def port(net, variables=None, **kw):
    cfg, classes, crop = NETS[net]
    params, stats = variables or trees(net)
    return Predictor(cfg, classes, params, stats, crop_size=crop, dtype=torch.float32,
                     device="cpu", **kw)


def graph_ops(path):
    program = torch.export.load(path)
    return [str(n.target) for n in program.graph.nodes if n.op == "call_function"]


def masks_of(out, predictor, shape):
    """The masks of an exported program's output, unpacked if packed."""
    preds = (out[0] if isinstance(out, tuple) else out).numpy()
    return unpack_bits(preds, shape, predictor.mask_bits) if predictor.pack_masks else preds


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("net", list(NETS))
def test_export_round_trip_matches_predict_and_jax(net, case, tmp_path):
    port_kw, jax_kw = CASES[case]
    cfg, classes, crop = NETS[net]
    imgs = images(net)
    pred = port(net, **port_kw)
    path = pred.export(str(tmp_path / "model.pt2"), batch_size=2)
    out = Predictor.run_exported(path, pred.variables, imgs)
    # the single-device function at the exported batch (two replicas run
    # half a batch each, whose f32 rounding may differ)
    single = pred if pred.n_devices == 1 else port(net)
    ref_p, ref_c = single.predict(imgs)
    got_p = masks_of(out, pred, imgs.shape[:3])
    np.testing.assert_array_equal(got_p, ref_p)
    if ref_c is None:
        assert not isinstance(out, tuple)
    else:
        np.testing.assert_array_equal(out[1].numpy(), ref_c)

    params, stats = trees(net)
    jax_pred = JaxPredictor(cfg, classes, params, stats, crop_size=crop,
                            dtype=jnp.float32, **jax_kw)
    jax_path = jax_pred.export(str(tmp_path / "model.stablehlo"), batch_size=2)
    jax_out = JaxPredictor.run_exported(jax_path, jax_pred.variables, imgs)
    jax_p = np.asarray(jax_out[0] if isinstance(jax_out, tuple) else jax_out)
    if pred.pack_masks:
        assert got_p.shape == imgs.shape[:3]
        jax_p = unpack_bits(jax_p, imgs.shape[:3], jax_pred.mask_bits)
    assert (got_p == jax_p).mean() >= MASK_AGREEMENT
    if ref_c is not None:
        np.testing.assert_allclose(out[1].numpy().astype(np.float32),
                                   np.asarray(jax_out[1]).astype(np.float32), atol=CONF_ATOL)


@pytest.mark.parametrize("net", list(NETS))
def test_graph_keeps_the_kernels_as_registered_ops(net, tmp_path):
    """One K10 node, and one K5 node per ABN layer of the served network
    (UNet's batch norms are plain, as JAX's ``nn.BatchNorm``): without them
    the CPU round trip would still match, while the card's program would
    run plain ops."""
    pred = port(net)
    ops = graph_ops(pred.export(str(tmp_path / "model.pt2"), batch_size=2))
    n_abn = sum(isinstance(m, ABN) for m in pred.model.modules())
    assert ops.count(f"{K10}.default") == 1
    assert ops.count(f"{K5}.default") == n_abn
    assert n_abn == (23 if net.startswith("deeplab") else 0)


def test_a_program_serves_other_weights(tmp_path):
    """Exported with weights A, run with weights B: B's ``predict``."""
    net = "deeplab-rn18-64"
    rs = np.random.RandomState(5)
    params_b = jax.tree.map(lambda a: np.asarray(a) * rs.uniform(0.8, 1.2, np.shape(a))
                            .astype(np.float32), trees(net)[0])
    a, b = port(net), port(net, (params_b, trees(net, seed=12)[1]))
    imgs = images(net, seed=3)
    path = a.export(str(tmp_path / "a.pt2"), batch_size=2)
    preds, conf = Predictor.run_exported(path, b.variables, imgs)
    ref_p, ref_c = b.predict(imgs)
    np.testing.assert_array_equal(preds.numpy(), ref_p)
    np.testing.assert_array_equal(conf.numpy(), ref_c)
    assert not np.array_equal(ref_c, a.predict(imgs)[1])


CHILD = """
import sys
import numpy as np
import torch

torch.set_num_threads(1)  # the parent's count: the CPU convolutions round alike
path, imgs_path, out_path = sys.argv[1:]
try:
    torch.export.load(path)
    print("loaded without the ops")
except Exception as e:
    print("without the ops:", type(e).__name__)
from bacs_tpu_torch.serve import load_exported

preds, conf = load_exported(path)(torch.from_numpy(np.load(imgs_path)))
np.savez(out_path, preds=preds.numpy(), conf=conf.numpy())
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "bacs_tpu"))
assert not bad, bad
"""


def test_a_fresh_process_loads_and_runs_the_file(tmp_path):
    net = "deeplab-rn18-64"
    pred = port(net)
    imgs = images(net, seed=4)
    path = pred.export(str(tmp_path / "model.pt2"), batch_size=2)
    np.save(tmp_path / "imgs.npy", imgs)
    out = str(tmp_path / "out.npz")
    run = subprocess.run([sys.executable, "-c", CHILD, path, str(tmp_path / "imgs.npy"), out],
                         capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    assert "without the ops:" in run.stdout, run.stdout
    got = np.load(out)
    ref_p, ref_c = pred.predict(imgs)
    np.testing.assert_array_equal(got["preds"], ref_p)
    np.testing.assert_array_equal(got["conf"], ref_c)


def test_predict_cli_exports_a_trained_checkpoint(tmp_path):
    """``python -m bacs_tpu_torch.predict --device cpu --export`` on the
    checkpoint of a small CPU run (``conf/joint_debug``, DeepLabV3-RN18,
    64^2, one epoch) writes a batch-8 program that ``run_exported`` serves
    with the checkpoint's weights as ``predict`` serves them (bf16, the
    command line's default)."""
    ckpt = str(tmp_path / "ckpt")
    overrides = ["network=deep_lab", "training.epochs=1", "training.val_every=0"]
    config = load_config(JOINT, "config", overrides + [f"+training.ckpt_dir={ckpt}"])
    Trainer(config, device="cpu").fit()
    path = str(tmp_path / "cli.pt2")
    run = subprocess.run(
        [sys.executable, "-m", "bacs_tpu_torch.predict", "--device", "cpu",
         "--config-path", JOINT, "--config-name", "config", "--checkpoint", ckpt,
         "--export", path, *overrides], capture_output=True, text=True, cwd=ROOT,
        timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    assert f"exported inference fn to {path}" in run.stdout
    pred = Predictor.from_checkpoint(ckpt, config, device="cpu")
    imgs = np.random.RandomState(6).randint(0, 256, (8, 64, 64, 3)).astype(np.uint8)
    preds, conf = Predictor.run_exported(path, pred.variables, imgs)
    ref_p, ref_c = pred.predict(imgs)
    np.testing.assert_array_equal(preds.numpy(), ref_p)
    np.testing.assert_array_equal(conf.numpy(), ref_c)
