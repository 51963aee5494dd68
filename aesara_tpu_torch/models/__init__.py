"""Symbolic model builders of the port (reference ``aesara_tpu/models``)."""

from aesara_tpu_torch.models.convert import load_params, params_by_name  # noqa: F401
from aesara_tpu_torch.models.linear import LinearRegression, LogisticRegression  # noqa: F401
from aesara_tpu_torch.models.optim import sgd  # noqa: F401
from aesara_tpu_torch.models.transformer import TransformerEncoderLayer, layer_norm  # noqa: F401
