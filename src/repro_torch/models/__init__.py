from repro_torch.models.resnet import ResNet, build_resnet

__all__ = ["ResNet", "build_resnet"]
