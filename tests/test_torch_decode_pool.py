"""The port's decode pool (``bacs_tpu_torch/data/decode_pool.py``), on the
CPU, at 2 workers at most.

- The pool's stream equals serial decoding and JAX's ``gather_host``,
  batch for batch, with the native batch decoder on both sides (each
  worker decodes natively) and with PIL on both sides (JAX's decoder and
  the port's masked; the pool's workers get a source without
  ``load_batch``), and a pool serves several epochs.
- The DataModule's train and eval streams are bit-identical at 0, 1 and 2
  workers (1 decodes in the prefetch thread, as 0 does).
- A worker's exception re-raises at the consumer.
- The caches (and a wrapper around one) stay in-process; ``num_workers``
  resolves as JAX's (``"auto"`` the host's cores, a count clamped to them).
"""

import numpy as np
import pytest

from bacs_tpu_torch.data import datamodule, datasets, decode_pool, layouts
from torch_port_helpers import _one_thread  # noqa: F401


@pytest.fixture(scope="module")
def voc_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("voc"))
    layouts.generate_voc(root, n_train=10, n_val=4, size=48)
    return root


@pytest.fixture(scope="module")
def voc_source(voc_root):
    return datasets.make_voc_source(voc_root, "train", 48)


@pytest.fixture(scope="module")
def pool(voc_source):
    p = decode_pool.DecodePool(voc_source, workers=2)
    yield p
    p.close()


BATCHES = [[0, 3, 1], [2, 2, 4], [9, 8, 7], [5, 6, 0], [1, 2, 3]]


class PilSource(datasets.FolderSource):
    """A folder source that decodes with PIL only (a host where the native
    decoder does not build), for the pool's workers."""

    def load_batch(self, indices):
        return None


@pytest.mark.parametrize("decoder", ["native", "pil"])
def test_pool_stream_matches_serial_and_jax(voc_root, voc_source, pool, monkeypatch, decoder):
    from bacs_tpu.data import decode_pool as jax_decode_pool
    from bacs_tpu.data import native_decode
    from bacs_tpu.data.datasets import make_voc_source
    from bacs_tpu_torch.data import native_decode as port_native_decode

    if decoder == "native":
        assert native_decode.available() and port_native_decode.available()
        source, stream = voc_source, pool.stream
    else:
        for module in (native_decode, port_native_decode):
            monkeypatch.setattr(module, "_LIB", None)
            monkeypatch.setattr(module, "_TRIED", True)
        source = PilSource(voc_source.image_paths, voc_source.label_paths, 48,
                           voc_source.class_names)
        pil_pool = decode_pool.DecodePool(source, workers=1)
        stream = pil_pool.stream
    ref_source = make_voc_source(voc_root, "train", 48)
    serial = [decode_pool.gather_host(voc_source, idx) for idx in BATCHES]
    ref = [jax_decode_pool.gather_host(ref_source, idx) for idx in BATCHES]
    for epoch in range(2):  # the pool serves epoch after epoch
        pooled = list(stream(BATCHES))
        assert len(pooled) == len(serial) == len(ref)
        for (si, sl), (pi, pl), (ri, rl) in zip(serial, pooled, ref):
            assert pi.shape == (3, 48, 48, 3) and pi.dtype == np.uint8
            assert np.array_equal(si, pi) and np.array_equal(sl, pl)
            assert np.array_equal(ri, pi) and np.array_equal(rl, pl)
    if decoder == "pil":
        pil_pool.close()


def test_worker_count_does_not_change_the_streams(voc_source):
    def streams(workers):
        dm = datamodule.DataModule(voc_source, voc_source, num_classes=21, crop_size=32,
                                   batch_size=4, seed=7, input_workers=workers,
                                   device="cpu")
        try:
            train = [{k: np.asarray(v) for k, v in b.items()}
                     for b in dm.train_batches(epoch=1)]
            evals = [{k: np.asarray(v) for k, v in b.items()} for b in dm.eval_batches(0)]
            assert bool(dm._pools) == (workers >= 2)
        finally:
            dm.close()
        return train + evals

    ref = streams(0)
    for workers in (1, 2):
        got = streams(workers)
        assert len(got) == len(ref) == 2 + 3
        for a, b in zip(got, ref):
            assert set(a) == set(b)
            for k in a:
                assert np.array_equal(a[k], b[k]), k


def test_worker_exception_reraises(voc_source):
    broken = datasets.FolderSource(voc_source.image_paths[:2] + ["/nonexistent/x.jpg"],
                                   voc_source.label_paths[:3], 48, voc_source.class_names)
    p = decode_pool.DecodePool(broken, workers=2)
    try:
        with pytest.raises(FileNotFoundError):
            list(p.stream([[0], [1], [2], [0]]))
        # the pool still serves after a failed batch
        assert len(list(p.stream([[0, 1]]))) == 1
    finally:
        p.close()


def test_caches_are_ineligible_and_workers_resolve_as_jax(voc_source, monkeypatch):
    from bacs_tpu.data import datamodule as jax_datamodule

    syn = datasets.SyntheticSource(4, 16, 6)
    assert decode_pool.pool_eligible(voc_source) and decode_pool.pool_eligible(syn)
    assert decode_pool.pool_eligible(datasets.DomainShiftedSource(syn, [0, 1, 0, 1]))
    device = datasets.DeviceCache(syn, "cpu")
    for cached in (datasets.DecodedCache(syn), device,
                   datasets.DomainShiftedSource(device, [0, 1, 0, 1])):
        assert not decode_pool.pool_eligible(cached)
    for value in ("auto", "AUTO", 0, None, 1, 2, 3, 10_000):
        assert datamodule._resolve_workers(value) == jax_datamodule._resolve_workers(value)
    monkeypatch.setattr(datamodule, "_host_cores", lambda: 3)
    assert datamodule._resolve_workers(12) == 3 and datamodule._resolve_workers("auto") == 3
    cfg = {"dataset": {"dataset": {"n_train": 4, "n_val": 2, "crop_size": 16}},
           "training": {"num_workers": 2}}
    assert datamodule.create_datamodule(cfg, "cpu").input_workers == 2
    cfg["training"]["input_workers"] = "auto"
    assert datamodule.create_datamodule(cfg, "cpu").input_workers == 3
