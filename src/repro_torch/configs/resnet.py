"""The paper's own workload models: ResNet-18 / ResNet-152 on FEMNIST.

LIFL §6 trains ResNet-18 (~44 MB updates) and ResNet-152 (~232 MB) with
FedAvg over FEMNIST.  These drive the paper-faithful examples and the
time-to-accuracy benchmark; they are not part of the 40-cell LM grid.
"""
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class ResNetConfig:
    name: str
    # stage specification: (block_type, channels, blocks) per stage
    block: str  # 'basic' | 'bottleneck'
    stage_blocks: Tuple[int, int, int, int]
    width: int = 64
    num_classes: int = 62  # FEMNIST
    in_channels: int = 1   # FEMNIST is grayscale 28x28
    image_size: int = 28

    def reduced(self) -> "ResNetConfig":
        return ResNetConfig(
            name=self.name + "-reduced",
            block=self.block,
            stage_blocks=(1, 1, 1, 1),
            width=8,
            num_classes=self.num_classes,
            in_channels=self.in_channels,
            image_size=self.image_size,
        )


RESNET18 = ResNetConfig(
    name="resnet18", block="basic", stage_blocks=(2, 2, 2, 2)
)
RESNET152 = ResNetConfig(
    name="resnet152", block="bottleneck", stage_blocks=(3, 8, 36, 3)
)
