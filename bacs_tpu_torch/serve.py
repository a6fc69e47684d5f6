"""Inference / serving path: a batched eval-mode forward with argmax.

Port of ``bacs_tpu/serve.py`` (``Predictor``).  One request is a uint8
[N, H, W, 3] batch; the Predictor normalizes it on the device, runs the
eval-mode network to its pre-upsample logits, and turns those into a uint8
mask and a confidence per pixel with the fused upsample+argmax kernel
(``ops/upsample_argmax.py``; UNet's logits are at the input's resolution,
and the kernel runs at scale 1; TranSeg's are float32 whatever ``dtype``,
as in JAX, and its first ``active_classes`` class tokens are in use).
Every ABN layer of a DeepLabV3 or TranSeg backbone runs the eval-ABN
kernel (``ops/abn_core.py``); UNet's batch norms are plain PyTorch, as
JAX's ``nn.BatchNorm`` is no Pallas kernel.  The wire formats
are the JAX package's: confidence as f16, as uint8 steps of 1/255 or not
at all, and masks as uint8 or bit-packed on the device
(``ops/bitpack.py``).

``device`` is explicit.  Asking for CUDA where there is none raises; the
Predictor never falls back to the CPU.  ``from_checkpoint`` serves the
newest checkpoint of a training run through the Trainer's own restore.

``n_devices`` > 1 serves data-parallel, as the JAX Predictor's mesh
(``bacs_tpu/serve.py:118-135``): one process holds a replica of the
network on each of the first ``n_devices`` cards (or on ``devices``, which
may list CPU devices), splits each batch into contiguous slices across
them, runs K10 on each replica, and gathers the slices on the first
device.  The eval forward has no cross-image state, so no collective
runs.  Fewer cards than asked warns and serves on those there are.

``export`` writes the single-device inference function (``ServeForward``,
the first replica's) with ``torch.export``; ``run_exported`` loads it and
runs it with any weights of the same shapes (``Predictor.variables``), as
JAX's ``export``/``run_exported`` do with StableHLO (``bacs_tpu/serve.py:
259-286``).  The two kernels are registered ops (``bacs::abn_eval``,
``bacs::upsample_argmax_conf``): the graph keeps them as nodes, and a
process that loads the file must have imported this module, which
registers them.
"""

from __future__ import annotations

import contextlib
import copy
import os
import warnings
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from bacs_tpu_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD
from bacs_tpu_torch.models import create_network
from bacs_tpu_torch.ops.bitpack import bits_needed, pack_bits, unpack_bits
from bacs_tpu_torch.ops.upsample_argmax import upsampled_argmax_conf
from bacs_tpu_torch.utils.flax_weights import load_flax_variables
from bacs_tpu_torch.viz.media import voc_colormap


def load_exported(path: str) -> nn.Module:
    """The module of a program that :meth:`Predictor.export` wrote.  Loading
    needs the ops ``bacs::*`` registered, which importing this module does
    (through ``ops/abn_core.py`` and ``ops/upsample_argmax.py``).  Its
    tensors take no gradient: it serves."""
    return torch.export.load(path).module().requires_grad_(False)


class ServeForward(nn.Module):
    """The single-device inference function, the JAX ``_infer``
    (``bacs_tpu/serve.py:77-104``): uint8 [N, H, W, 3] -> normalize ->
    ``sem_logits[..., :active]`` in ``dtype`` -> K10 -> confidence as f16,
    uint8 steps of 1/255 or none -> masks bit-packed to ``mask_bits`` when
    set.  Returns ``(preds, conf)``, or ``preds`` alone with
    ``conf_dtype="none"``.  :meth:`Predictor.export` exports it."""

    def __init__(self, net: nn.Module, active: int, dtype: torch.dtype, conf_dtype: str,
                 mask_bits: Optional[int]):
        super().__init__()
        self.net = net
        self.active, self.dtype = active, dtype
        self.conf_dtype, self.mask_bits = conf_dtype, mask_bits
        dev = next(net.parameters()).device
        for name, v in (("mean", IMAGENET_MEAN), ("std", IMAGENET_STD)):
            self.register_buffer(name, torch.tensor(v, dtype=torch.float32, device=dev),
                                 persistent=False)

    def forward(self, images_u8: torch.Tensor):
        x = ((images_u8.float() / 255.0 - self.mean) / self.std).to(self.dtype)
        sem = self.net.sem_logits(x)[..., : self.active]
        preds, conf = upsampled_argmax_conf(sem.contiguous(),
                                            (images_u8.shape[1], images_u8.shape[2]))
        if self.conf_dtype == "uint8":
            conf = torch.round(conf.float() * 255.0).to(torch.uint8)
        if self.mask_bits is not None:
            preds = pack_bits(preds, self.mask_bits)
        return preds if self.conf_dtype == "none" else (preds, conf)


def replica_devices(device: torch.device, n_devices: Optional[int] = None,
                    devices: Optional[Sequence[str | torch.device]] = None) -> List[torch.device]:
    """The replicas' devices: ``devices`` as given, else ``device`` alone or
    with ``n_devices`` > 1 the first ``n_devices`` cards, warning when
    fewer are visible (``bacs_tpu/serve.py:100-117``)."""
    if devices:
        return [torch.device(d) for d in devices]
    if not n_devices or n_devices <= 1:
        return [device]
    if device.type != "cuda":
        return [device] * n_devices
    avail = torch.cuda.device_count()
    got = min(n_devices, avail)
    if got < n_devices:
        warnings.warn(f"Predictor(n_devices={n_devices}) but only {avail} CUDA device(s) "
                      f"visible — serving on {got}.", stacklevel=3)
    return [torch.device("cuda", i) for i in range(got)]


class Predictor:
    def __init__(
        self,
        network_cfg: dict,
        num_classes: int,
        params,
        batch_stats,
        crop_size: int = 512,
        active_classes: Optional[int] = None,
        dtype: torch.dtype = torch.bfloat16,
        conf_dtype: str = "float16",
        pack_masks: bool = False,
        n_devices: Optional[int] = None,
        device: str | torch.device = "cuda",
        devices: Optional[Sequence[str | torch.device]] = None,
    ):
        """``params``/``batch_stats`` are the JAX package's Flax trees
        (nested mappings of arrays), converted by ``utils/flax_weights.py``.
        ``devices`` names the replicas' devices (default: ``device``, or
        with ``n_devices`` > 1 the first ``n_devices`` cards)."""
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "Predictor(device='cuda') but torch sees no CUDA device; pass "
                "device='cpu' to serve on the CPU"
            )
        self.devices = replica_devices(self.device, n_devices, devices)
        self.device = self.devices[0]
        self.n_devices = len(self.devices)
        self.crop_size = crop_size
        self.num_classes = num_classes
        self.active_classes = active_classes or num_classes
        self.dtype = dtype
        if self.active_classes > 255:
            # uint8 mask payload: class ids must fit, 255 stays the ignore id
            raise ValueError("uint8 mask payload needs <= 255 classes")
        if conf_dtype not in ("float16", "uint8", "none"):
            raise ValueError("conf_dtype must be 'float16', 'uint8' or 'none'")
        self.conf_dtype = conf_dtype
        self.pack_masks = bool(pack_masks)
        self.mask_bits = bits_needed(self.active_classes) if pack_masks else 8
        self.model = create_network(
            network_cfg.get("_target_", "networks.DeepLabV3"),
            num_classes=num_classes,
            active_classes=self.active_classes,
            norm=str(network_cfg.get("norm", "iabn_sync")),
            crop_size=crop_size,
            dtype=dtype,
            **{k: v for k, v in network_cfg.items()
               if k in ("backbone", "output_stride", "n_channels", "bilinear",
                        "num_layers", "transformer", "atrous_encoder")},
        )
        load_flax_variables(self.model, params, batch_stats)
        self.model.eval().to(self.device)
        self.replicas = [self.model] + [copy.deepcopy(self.model).to(d)
                                        for d in self.devices[1:]]
        self.forwards = [ServeForward(m, self.active_classes, dtype, conf_dtype,
                                      self.mask_bits if self.pack_masks else None)
                         for m in self.replicas]
        # device->host copies run on their own stream, so batch i's copy
        # overlaps batch i+1's forward (predict_many)
        self._copy_stream = (
            torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        )

    # ------------------------------------------------------------------

    @classmethod
    def from_checkpoint(cls, ckpt_dir: str, config, device: str | torch.device = "cuda",
                        **kwargs) -> "Predictor":
        """The newest task checkpoint the Trainer saved under ``ckpt_dir``
        (``utils/checkpoint.py``), served at that task's class count."""
        from bacs_tpu_torch.train.loop import Trainer
        from bacs_tpu_torch.utils.checkpoint import latest_checkpoint
        from bacs_tpu_torch.utils.torch_weights import model_variables

        found = latest_checkpoint(ckpt_dir)
        if not found:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
        task_id, path = found
        trainer = Trainer(config, device=device)
        state = trainer.restore(task_id, path)
        variables = model_variables(state.model)
        # the seen detector takes no part in serving, and the served network
        # is built without it (JAX's apply ignores its variables)
        for tree in variables.values():
            tree.pop("seen_fg_network", None)
        return cls(
            dict(config.get("network", {})),
            trainer.datamodule.num_classes,
            variables["params"],
            variables["batch_stats"],
            crop_size=trainer.datamodule.crop_size,
            active_classes=trainer._task_info(task_id).nb_current_classes,
            device=device,
            **kwargs,
        )

    @property
    def variables(self) -> Dict[str, torch.Tensor]:
        """The served network's tensors by name (its ``state_dict``): what
        :meth:`run_exported` serves an exported program with."""
        return dict(self.model.state_dict())

    def export(self, path: str, batch_size: int = 8) -> str:
        """Write the single-device inference function at ``batch_size``
        (uint8 [batch_size, crop, crop, 3] in, the wire format out) with
        ``torch.export`` to ``path``; returns ``path``.

        The program is traced on the Predictor's device and runs there.  A
        Predictor with several replicas exports the first one's function,
        as JAX's does (``bacs_tpu/serve.py:266-271``).  The eval ABNs and the
        upsample+argmax stay the registered ops ``bacs::abn_eval`` and
        ``bacs::upsample_argmax_conf``, so the loaded program launches the
        same kernels as :meth:`predict`.
        """
        torch.export.save(self.export_program(batch_size), path)
        return path

    def export_program(self, batch_size: int = 8) -> torch.export.ExportedProgram:
        """The ``torch.export`` program that :meth:`export` writes."""
        x = torch.zeros((batch_size, self.crop_size, self.crop_size, 3),
                        dtype=torch.uint8, device=self.device)
        with torch.no_grad():
            return torch.export.export(self.forwards[0], (x,))

    @staticmethod
    def run_exported(path: str, variables: Dict[str, torch.Tensor], images_u8):
        """Run the program :meth:`export` wrote on uint8 images with the
        network tensors ``variables`` (a :attr:`variables` map of any
        Predictor of the same shapes): ``(preds, conf)``, or ``preds`` alone
        for ``conf_dtype="none"``, packed if the exporter packed, as
        tensors on the program's device."""
        module = load_exported(path)
        dev = next(iter(module.state_dict().values())).device
        tensors = {f"net.{k}": torch.as_tensor(v).to(dev) for k, v in variables.items()}
        with torch.inference_mode():
            return torch.func.functional_call(
                module, tensors, (torch.as_tensor(images_u8).to(dev),))

    # ------------------------------------------------------------------

    @torch.inference_mode()
    def _infer(self, images_u8: torch.Tensor):
        # contiguous slices, one per replica; each launch is queued on its
        # own card before any result is gathered
        outs = []
        for fwd, x, dev in zip(self.forwards, images_u8.chunk(self.n_devices), self.devices):
            with torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext():
                out = fwd(x.to(dev, non_blocking=True))
            outs.append(out if isinstance(out, tuple) else (out,))
        if len(outs) > 1:
            outs = [tuple(torch.cat([o[i].to(self.device) for o in outs])
                          for i in range(len(outs[0])))]
        preds, *conf = outs[0]
        return preds, (conf[0] if conf else None)

    def predict(self, images: np.ndarray):
        """images: uint8 [N, H, W, 3] at crop size -> (preds [N,H,W], conf).

        conf is None with conf_dtype="none"; packed masks are unpacked here
        so the wire format is invisible to callers.
        """
        return next(iter(self.predict_many([images])))

    def _dispatch(self, images: np.ndarray):
        if images.shape[0] % self.n_devices:
            raise ValueError(f"batch {images.shape[0]} not divisible by the Predictor's "
                             f"{self.n_devices} devices")
        x = torch.from_numpy(np.ascontiguousarray(images, np.uint8))
        if self._copy_stream is None:
            return self._infer(x), None
        out = self._infer(x.pin_memory().to(self.device, non_blocking=True))
        done = torch.cuda.Event()
        done.record()
        return out, done

    def _materialize(self, out, done, shape):
        preds, conf = out
        if done is not None:
            with torch.cuda.stream(self._copy_stream):
                self._copy_stream.wait_event(done)
                host = []
                for t in (preds, conf):
                    if t is not None:
                        t.record_stream(self._copy_stream)
                        t = t.to("cpu", non_blocking=True)
                    host.append(t)
            self._copy_stream.synchronize()
            preds, conf = host
        preds = preds.numpy()
        if self.pack_masks:
            preds = unpack_bits(preds, shape, self.mask_bits)
        return preds, (None if conf is None else conf.numpy())

    def predict_many(self, batches: Iterable[np.ndarray]):
        """Pipelined prediction over an iterable of uint8 batches.

        Dispatches batch i+1's device computation BEFORE copying batch i's
        results to the host, so the forward hides under the transfer.
        Yields (preds, conf) per batch, the same as :meth:`predict`.
        """
        pending = None  # (device output, its completion event, batch shape)
        for images in batches:
            out, done = self._dispatch(images)
            if pending is not None:
                yield self._materialize(*pending)
            pending = (out, done, images.shape[:3])
        if pending is not None:
            yield self._materialize(*pending)

    def predict_files(
        self, paths: Sequence[str], out_dir: Optional[str] = None,
        batch_size: int = 8,
    ) -> List[np.ndarray]:
        from PIL import Image

        cmap = voc_colormap()
        results = []
        for i in range(0, len(paths), batch_size):
            chunk = paths[i : i + batch_size]
            imgs = []
            for p in chunk:
                img = Image.open(p).convert("RGB").resize(
                    (self.crop_size, self.crop_size), Image.BILINEAR
                )
                imgs.append(np.asarray(img, np.uint8))
            batch = np.stack(imgs)
            if len(chunk) < batch_size:
                batch = np.resize(batch, (batch_size,) + batch.shape[1:])
            preds, _ = self.predict(batch)
            for j, p in enumerate(chunk):
                mask = preds[j]
                results.append(mask)
                if out_dir:
                    os.makedirs(out_dir, exist_ok=True)
                    name = os.path.splitext(os.path.basename(p))[0]
                    Image.fromarray(cmap[np.clip(mask, 0, 255)]).save(
                        os.path.join(out_dir, f"{name}_mask.png")
                    )
        return results
