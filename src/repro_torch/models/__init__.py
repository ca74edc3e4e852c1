from .model import Model, build_model
