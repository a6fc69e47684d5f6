"""Continual-learning methods (port of ``bacs_tpu/methods``).

Every method of the JAX package: the fine-tuning cross-entropy baseline,
Prototypes, MiB, PLOP, iCaRL, Experience Replay, SDR and BACS.
``create_method`` keeps the JAX registry's names (reference ``_target_``
strings).
"""

from bacs_tpu_torch.methods.base import Method, ModelContext, StepAux  # noqa: F401
from bacs_tpu_torch.methods.ce import CrossEntropyMethod  # noqa: F401
from bacs_tpu_torch.methods.mib import MiBMethod  # noqa: F401
from bacs_tpu_torch.methods.plop import PlopMethod  # noqa: F401
from bacs_tpu_torch.methods.prototypes import PrototypesMethod  # noqa: F401
from bacs_tpu_torch.methods.icarl import IcarlMethod  # noqa: F401
from bacs_tpu_torch.methods.er import ExperienceReplayMethod  # noqa: F401
from bacs_tpu_torch.methods.sdr import SDRMethod  # noqa: F401
from bacs_tpu_torch.methods.bacs import BACSMethod  # noqa: F401

_METHODS = {
    "loss.crossentropy": CrossEntropyMethod,
    "crossentropy": CrossEntropyMethod,
    "loss.mib": MiBMethod,
    "mib": MiBMethod,
    "loss.ploploss": PlopMethod,
    "plop": PlopMethod,
    "ploploss": PlopMethod,
    "loss.prototypes": PrototypesMethod,
    "prototypes": PrototypesMethod,
    "loss.icarlloss": IcarlMethod,
    "icarl": IcarlMethod,
    "icarlloss": IcarlMethod,
    "loss.experiencereplay": ExperienceReplayMethod,
    "experiencereplay": ExperienceReplayMethod,
    "er": ExperienceReplayMethod,
    "loss.sdr": SDRMethod,
    "sdr": SDRMethod,
    "loss.bacsloss": BACSMethod,
    "bacs": BACSMethod,
    "bacsloss": BACSMethod,
}


def create_method(target: str, **kwargs) -> Method:
    key = target.lower().replace("_", "")
    if key not in _METHODS:
        key = key.rsplit(".", 1)[-1]
    if key not in _METHODS:
        raise ValueError(f"unknown loss/method {target!r}")
    return _METHODS[key](**kwargs)
