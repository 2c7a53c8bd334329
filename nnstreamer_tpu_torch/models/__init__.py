"""Model zoo (torch): bundles, seeded zoo models, the flax weight converter,
and deployment from model files (models/deploy.py)."""

from .deploy import export_model, load_checkpointed, load_exported
from .zoo import ModelBundle, get_model, model_names, register_model

__all__ = ["ModelBundle", "export_model", "get_model", "load_checkpointed",
           "load_exported", "model_names", "register_model"]
