"""Config loading: the ``conf/`` trees and the override grammar of ``main.py``."""

from bacs_tpu_torch.config.core import Config, load_config, parse_overrides  # noqa: F401
