"""The deprecated module name ``tensor/subtensor_opt.py``: the rewrites of
``tensor/rewriting/subtensor.py`` under it."""
from aesara_tpu_torch.tensor.rewriting.subtensor import *  # noqa: F401,F403
