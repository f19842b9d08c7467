"""Model framework: wrappers, registry, input spec, zoo."""

from . import common, config, input, model
from .config import ModelSpec, load, load_input, load_loss, load_model
from .input import Input, InputSpec
from .model import Loss, Model, ModelAdapter, Result

__all__ = [
    "common", "config", "input", "model",
    "ModelSpec", "load", "load_input", "load_loss", "load_model",
    "Input", "InputSpec", "Loss", "Model", "ModelAdapter", "Result",
]
