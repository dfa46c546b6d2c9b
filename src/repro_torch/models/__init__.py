from repro_torch.models.registry import ModelApi, build_model

__all__ = ["ModelApi", "build_model"]
