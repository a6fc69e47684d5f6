"""Continual-learning methods (port of ``bacs_tpu/methods``).

Ported so far: the fine-tuning cross-entropy baseline, BACS, MiB and PLOP.
``create_method`` keeps the JAX registry's names (reference ``_target_``
strings); every method not ported yet raises, naming its ROADMAP.md item.
"""

from bacs_tpu_torch.methods.bacs import BACSMethod  # noqa: F401
from bacs_tpu_torch.methods.base import Method, ModelContext, StepAux  # noqa: F401
from bacs_tpu_torch.methods.ce import CrossEntropyMethod  # noqa: F401
from bacs_tpu_torch.methods.mib import MiBMethod  # noqa: F401
from bacs_tpu_torch.methods.plop import PlopMethod  # noqa: F401

_METHODS = {
    "loss.crossentropy": CrossEntropyMethod,
    "crossentropy": CrossEntropyMethod,
    "loss.bacsloss": BACSMethod,
    "bacs": BACSMethod,
    "bacsloss": BACSMethod,
    "loss.mib": MiBMethod,
    "mib": MiBMethod,
    "loss.ploploss": PlopMethod,
    "plop": PlopMethod,
    "ploploss": PlopMethod,
}

# the JAX registry's other names -> the ROADMAP.md item that ports them
_NOT_PORTED = {
    **{k: "queue 1 item 11" for k in (
        "loss.prototypes", "prototypes", "loss.icarlloss", "icarl",
        "icarlloss", "loss.sdr", "sdr")},
    **{k: "queue 1 item 9" for k in (
        "loss.experiencereplay", "experiencereplay", "er")},
}


def create_method(target: str, **kwargs) -> Method:
    key = target.lower().replace("_", "")
    if key not in _METHODS and key not in _NOT_PORTED:
        key = key.rsplit(".", 1)[-1]
    if key in _NOT_PORTED:
        raise NotImplementedError(
            f"method {target!r} is not ported yet: ROADMAP.md {_NOT_PORTED[key]}"
        )
    if key not in _METHODS:
        raise ValueError(f"unknown loss/method {target!r}")
    return _METHODS[key](**kwargs)
