"""Data loading, sample/message streams and checkpoints for the port."""

from ssme_tpu_torch.io.checkpoint import (load_checkpoint,
                                          load_jax_checkpoint,
                                          save_checkpoint, state_from_jax)
from ssme_tpu_torch.io.csv import ParamSampler, read_data, read_params_csv
from ssme_tpu_torch.io.recording import (MESSAGE_HEADER, MessageWriter,
                                         SampleWriter, timestamped_path)

__all__ = ["read_data", "read_params_csv", "ParamSampler", "SampleWriter",
           "MessageWriter", "MESSAGE_HEADER", "timestamped_path", "save_checkpoint",
           "load_checkpoint", "state_from_jax", "load_jax_checkpoint"]
