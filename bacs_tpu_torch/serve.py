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
Predictor never falls back to the CPU.  Multi-GPU serving, ``export`` and
``from_checkpoint`` are ROADMAP.md queue 1 items 10 and 13 and raise.
"""

from __future__ import annotations

import os
from typing import Iterable, List, Optional, Sequence

import numpy as np
import torch

from bacs_tpu_torch.data.transforms import normalize_image
from bacs_tpu_torch.models import create_network
from bacs_tpu_torch.ops.bitpack import bits_needed, pack_bits, unpack_bits
from bacs_tpu_torch.ops.upsample_argmax import upsampled_argmax_conf
from bacs_tpu_torch.utils.flax_weights import load_flax_variables
from bacs_tpu_torch.viz.media import voc_colormap


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
    ):
        """``params``/``batch_stats`` are the JAX package's Flax trees
        (nested mappings of arrays), converted by ``utils/flax_weights.py``."""
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "Predictor(device='cuda') but torch sees no CUDA device; pass "
                "device='cpu' to serve on the CPU"
            )
        if n_devices is not None and n_devices > 1:
            raise NotImplementedError(
                "multi-GPU serving is ROADMAP.md queue 1 item 10"
            )
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
        # device->host copies run on their own stream, so batch i's copy
        # overlaps batch i+1's forward (predict_many)
        self._copy_stream = (
            torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        )

    # ------------------------------------------------------------------

    @classmethod
    def from_checkpoint(cls, ckpt_dir: str, config, **kwargs) -> "Predictor":
        raise NotImplementedError(
            "from_checkpoint needs the trainer and the checkpoint port: "
            "ROADMAP.md queue 1 items 8 and 13"
        )

    def export(self, path: str, batch_size: int = 8) -> str:
        raise NotImplementedError("export is ROADMAP.md queue 1 item 13")

    # ------------------------------------------------------------------

    @torch.inference_mode()
    def _infer(self, images_u8: torch.Tensor):
        x = normalize_image(images_u8).to(self.dtype)
        sem = self.model.sem_logits(x)[..., : self.active_classes]
        preds, conf = upsampled_argmax_conf(
            sem.contiguous(), (images_u8.shape[1], images_u8.shape[2])
        )
        if self.conf_dtype == "uint8":
            conf = torch.round(conf.float() * 255.0).to(torch.uint8)
        if self.pack_masks:
            preds = pack_bits(preds, self.mask_bits)
        return preds, (None if self.conf_dtype == "none" else conf)

    def predict(self, images: np.ndarray):
        """images: uint8 [N, H, W, 3] at crop size -> (preds [N,H,W], conf).

        conf is None with conf_dtype="none"; packed masks are unpacked here
        so the wire format is invisible to callers.
        """
        return next(iter(self.predict_many([images])))

    def _dispatch(self, images: np.ndarray):
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
