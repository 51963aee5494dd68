"""Symbolic model builders of the port (reference ``aesara_tpu/models``)."""

from aesara_tpu_torch.models.convert import load_params, load_state, named_state, params_by_name  # noqa: F401
from aesara_tpu_torch.models.linear import LinearRegression, LogisticRegression  # noqa: F401
from aesara_tpu_torch.models.mlp import MLP  # noqa: F401
from aesara_tpu_torch.models.rnn import GRU, LSTM, ElmanRNN  # noqa: F401
from aesara_tpu_torch.models.checkpoint import load_checkpoint, save_checkpoint, state_shareds  # noqa: F401
from aesara_tpu_torch.models.optim import (  # noqa: F401
    accumulate_gradients, adam, adamw, adamw_from_grads, clip_by_global_norm, ema_updates, momentum, rmsprop,
    scaled_loss_updates, sgd, warmup_cosine,
)
from aesara_tpu_torch.models.transformer import TransformerEncoderLayer, layer_norm  # noqa: F401
from aesara_tpu_torch.models.decoder import DecoderLM, TransformerDecoderLayer  # noqa: F401
from aesara_tpu_torch.models.quant import dequantize_expr, quantize_array_int8, quantize_decoder_int8  # noqa: F401
from aesara_tpu_torch.models.serve import ContinuousBatcher  # noqa: F401
