"""Dataset downloads into the on-disk layouts ``datasets.py`` reads.

Port of ``bacs_tpu/data/download.py`` (``dataset.download``), mirroring the
reference's downloaders:

- VOC 2012 + SegmentationClassAug masks + train_aug.txt split
  (reference: dataset/voc.py:60-115)
- ADE20K ADEChallengeData2016 (reference: dataset/ade20k.py:1-60)
- Cityscapes via an authenticated session (packageID 1 = gtFine,
  3 = leftImg8bit; reference: dataloaders/cityscape_datamodule.py:134-166)

Every function is idempotent (skips completed layouts) and raises
``DownloadError`` with the manual-layout instructions when the network is
unreachable, so an offline host gets an actionable message instead of a
stack trace.  A URL may be a ``file://`` one (an archive already on disk).
"""

from __future__ import annotations

import os
import shutil
import urllib.request
import zipfile
import tarfile

VOC_URL = (
    "http://host.robots.ox.ac.uk/pascal/VOC/voc2012/VOCtrainval_11-May-2012.tar"
)
VOC_AUG_URL = "http://cs.jhu.edu/~cxliu/data/SegmentationClassAug.zip"
VOC_AUG_SPLIT_URL = (
    "https://raw.githubusercontent.com/VainF/DeepLabV3Plus-Pytorch/master/"
    "datasets/data/train_aug.txt"
)
ADE_URL = (
    "http://data.csail.mit.edu/places/ADEchallenge/ADEChallengeData2016.zip"
)
CITYSCAPES_LOGIN = "https://www.cityscapes-dataset.com/login/"
CITYSCAPES_PKG = "https://www.cityscapes-dataset.com/file-handling/?packageID={}"


class DownloadError(RuntimeError):
    pass


def _fetch(url: str, dest: str) -> str:
    """Download url → dest (atomic); raises DownloadError offline."""
    if os.path.exists(dest):
        return dest
    os.makedirs(os.path.dirname(dest) or ".", exist_ok=True)
    tmp = dest + ".part"
    try:
        with urllib.request.urlopen(url, timeout=60) as r, open(tmp, "wb") as f:
            shutil.copyfileobj(r, f)
    except Exception as e:  # no egress / auth wall / bad URL
        if os.path.exists(tmp):
            os.remove(tmp)
        raise DownloadError(
            f"could not download {url}: {e}. This host may have no "
            "network egress — place the files manually (see datasets.py "
            "docstrings for the expected layout)."
        ) from e
    os.replace(tmp, dest)
    return dest


def _extract(archive: str, dest_dir: str) -> None:
    os.makedirs(dest_dir, exist_ok=True)
    dest_real = os.path.realpath(dest_dir)
    if archive.endswith(".zip"):
        with zipfile.ZipFile(archive) as z:
            # reject members escaping dest (zip-slip: archives arrive over
            # plain http)
            for name in z.namelist():
                target = os.path.realpath(os.path.join(dest_real, name))
                if not target.startswith(dest_real + os.sep):
                    raise DownloadError(f"unsafe zip member path: {name!r}")
            z.extractall(dest_dir)
    else:
        with tarfile.open(archive) as t:
            t.extractall(dest_dir, filter="data")  # tar-slip guard


def download_voc(root: str) -> str:
    """VOC2012 + aug masks → `<root>/VOCdevkit/VOC2012` (reference layout)."""
    root = os.path.expanduser(root)
    voc_root = os.path.join(root, "VOCdevkit", "VOC2012")
    if not os.path.isdir(os.path.join(voc_root, "JPEGImages")):
        tar = _fetch(VOC_URL, os.path.join(root, "VOCtrainval_11-May-2012.tar"))
        _extract(tar, root)
    mask_dir = os.path.join(voc_root, "SegmentationClassAug")
    if not os.path.isdir(mask_dir):
        zip_path = _fetch(
            VOC_AUG_URL, os.path.join(voc_root, "SegmentationClassAug.zip")
        )
        _extract(zip_path, voc_root)
    split = os.path.join(voc_root, "ImageSets", "Segmentation", "train_aug.txt")
    if not os.path.exists(split):
        _fetch(VOC_AUG_SPLIT_URL, split)
    return voc_root


def download_ade20k(root: str) -> str:
    """ADE20K → `<root>/ADEChallengeData2016`."""
    root = os.path.expanduser(root)
    base = os.path.join(root, "ADEChallengeData2016")
    if not os.path.isdir(os.path.join(base, "images")):
        zip_path = _fetch(ADE_URL, os.path.join(root, "ADEChallengeData2016.zip"))
        _extract(zip_path, root)
    return base


def download_cityscapes(root: str, username: str, password: str) -> str:
    """Cityscapes gtFine + leftImg8bit via the authenticated session the
    reference uses (cityscape_datamodule.py:134-166)."""
    root = os.path.expanduser(root)
    fine_zip = os.path.join(root, "gtFine_trainvaltest.zip")
    img_zip = os.path.join(root, "leftImg8bit_trainvaltest.zip")
    if os.path.isdir(os.path.join(root, "leftImg8bit")) and os.path.isdir(
        os.path.join(root, "gtFine")
    ):
        return root
    if not (os.path.isfile(fine_zip) and os.path.isfile(img_zip)):
        try:
            import requests
        except ImportError as e:  # requests is not installed everywhere
            raise DownloadError(
                "cityscapes download needs the `requests` package and "
                "network egress; place gtFine/ and leftImg8bit/ under "
                f"{root} manually"
            ) from e
        try:
            session = requests.Session()
            session.post(
                CITYSCAPES_LOGIN,
                {"username": username, "password": password, "submit": "Login"},
                timeout=60,
            )
            for pkg, dest in ((1, fine_zip), (3, img_zip)):
                if os.path.isfile(dest):
                    continue
                # stream: leftImg8bit_trainvaltest.zip is ~11 GB — never
                # buffer it in RAM
                r = session.get(
                    CITYSCAPES_PKG.format(pkg), allow_redirects=True,
                    timeout=600, stream=True,
                )
                r.raise_for_status()
                os.makedirs(root, exist_ok=True)
                with open(dest + ".part", "wb") as f:
                    for chunk in r.iter_content(chunk_size=1 << 20):
                        f.write(chunk)
                os.replace(dest + ".part", dest)
        except Exception as e:
            raise DownloadError(
                f"cityscapes authenticated download failed: {e}"
            ) from e
    for z in (fine_zip, img_zip):
        _extract(z, root)
    return root
