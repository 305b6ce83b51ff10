from repro_torch.models.registry import LM, build_model
from repro_torch.models.resnet import ResNet, build_resnet
from repro_torch.models.transformer import ModelOptions

__all__ = ["LM", "build_model", "ResNet", "build_resnet", "ModelOptions"]
