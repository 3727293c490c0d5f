"""The paper's edge models, on nested dicts of tensors."""
