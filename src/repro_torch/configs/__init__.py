from repro_torch.configs.resnet import RESNET18, RESNET152, ResNetConfig

__all__ = ["RESNET18", "RESNET152", "ResNetConfig"]
