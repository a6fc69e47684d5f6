"""The host data path on the card: ``training.profile_dir`` and a natively
decoded folder tree resident on the card.

Every test needs a CUDA device and skips with a reason where torch sees
none; run them on a GPU machine with
``python -m pytest tests/test_torch_host_data_cuda.py -q``.

- A ``Trainer`` with ``training.profile_dir`` on the card writes one
  Chrome trace of task 0's step loop, which holds the CUDA kernels of the
  train step: K1 (the upsample+CE sums and gradient) and K5 (the ABN
  apply, Triton).
- A ``cache_decoded=device`` DataModule over a VOC tree serves the same
  batches as the same DataModule on the CPU, both decoding the tree
  natively where the decoder builds (with PIL on a host without
  ``jpeglib.h`` and ``png.h``, as the H100 machine is).
"""

import json
import os

import numpy as np
import pytest
import torch

from bacs_tpu_torch.data import datamodule, layouts, native_decode
from torch_port_helpers import _one_thread  # noqa: F401

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the traced kernels and the resident set live there")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def voc_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("voc"))
    layouts.generate_voc(root, n_train=12, n_val=6, size=96)
    return root


def test_profile_dir_traces_the_kernels_of_task_zero(cuda, tmp_path):
    from bacs_tpu_torch.config import load_config
    from bacs_tpu_torch.train.loop import Trainer

    prof = tmp_path / "prof"
    config = load_config("conf/continual_debug", "config", [
        "network=deep_lab", "network.backbone=resnet18", "dataset.dataset.crop_size=64",
        f"+training.profile_dir={prof}"])
    Trainer(config, device="cuda").fit()
    assert os.listdir(prof) == ["trace.json"]
    with open(prof / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    kernels = {e["name"] for e in events if e.get("cat") == "kernel"}
    assert any("sums_kernel" in k for k in kernels), sorted(kernels)[:20]  # K1 forward
    assert any("grad_bands_kernel" in k for k in kernels)  # K1 backward
    assert any("abn" in k for k in kernels)  # K5


def test_device_cache_serves_the_cpu_batches(cuda, voc_root):
    from bacs_tpu_torch.kernels import host_build

    # where g++ finds both headers, the tree decodes natively
    assert native_decode.available() == all(host_build.header_probe().values())
    config = {"dataset": {"_target_": "dataloaders.VocDataModule", "dataset": {
                  "root": voc_root, "num_classes": 21, "crop_size": 64,
                  "cache_decoded": "device"}},
              "training": {"batch_size": 4, "seed": 42, "initial_increment": 15,
                           "increment": 5, "mode": "overlap"}}
    on_card = datamodule.create_datamodule(config, "cuda")
    on_cpu = datamodule.create_datamodule(config, "cpu")
    assert on_card.decoder == on_cpu.decoder == ("native" if native_decode.available()
                                                 else "PIL")
    for t in range(on_card.n_tasks):
        on_card.set_task_id(t)
        on_cpu.set_task_id(t)
        assert np.array_equal(on_card.train_indices(), on_cpu.train_indices())
        a = list(on_card.train_batches(0, augment=False))
        b = list(on_cpu.train_batches(0, augment=False))
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert x["image"].device.type == "cuda"
            assert torch.equal(x["label"].cpu(), y["label"])
            torch.testing.assert_close(x["image"].cpu(), y["image"], rtol=0, atol=1e-6)
        for x, y in zip(on_card.eval_batches(t), on_cpu.eval_batches(t)):
            assert x["n_real"] == y["n_real"] and torch.equal(x["label"].cpu(), y["label"])
