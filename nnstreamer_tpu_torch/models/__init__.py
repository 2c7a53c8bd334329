"""Model zoo (torch): bundles, seeded zoo models, the flax weight converter."""

from .zoo import ModelBundle, get_model, model_names, register_model

__all__ = ["ModelBundle", "get_model", "model_names", "register_model"]
