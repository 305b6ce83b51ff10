"""ResNet-18/152 with GroupNorm in PyTorch — the paper's FL workload.

The port of ``repro.models.resnet``.  The network is an ``nn.Module``;
:class:`ResNet` keeps the JAX package's functional surface —
``init(seed)``, ``apply(params, images)`` and ``loss(params, batch)``
on a parameter tree — through ``torch.func.functional_call``, so the
trainer differentiates a plain dict of tensors.

Layouts: images are NHWC at the public functions, as in the JAX
package; inside, activations are NCHW and conv weights OIHW (the
parameter tree holds OIHW; ``repro_torch.convert`` maps to and from the
JAX package's HWIO).  Two details decide whether the numbers match:

* XLA's ``"SAME"`` padding puts the odd pixel of an odd total pad at
  the end (a stride-2 3×3 conv on 28×28 pads (0, 1), not (1, 1)), so
  such convs pad explicitly with ``F.pad``;
* GroupNorm uses ``g = min(8, C)`` decremented until it divides ``C``,
  the population variance and eps 1e-5 — what ``F.group_norm`` does
  with contiguous channel groups.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.func import functional_call

from repro_torch.configs.resnet import ResNetConfig
from repro_torch.device import resolve_device
from repro_torch.tree import named_leaves, tree_from_named


def _same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """NCHW × OIHW conv with XLA "SAME" padding."""
    k = w.shape[-1]
    ph = _same_pads(x.shape[2], k, stride)
    pw = _same_pads(x.shape[3], k, stride)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return F.conv2d(x, w, stride=stride, padding=(ph[0], pw[0]))
    return F.conv2d(F.pad(x, (pw[0], pw[1], ph[0], ph[1])), w, stride=stride)


def _groups(c: int, groups: int = 8) -> int:
    g = min(groups, c)
    while c % g:
        g -= 1
    return g


class GroupNorm(nn.Module):
    """GroupNorm with the JAX package's parameter names (scale, bias)."""

    def __init__(self, c: int):
        super().__init__()
        self.groups = _groups(c)
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x, self.groups, self.scale, self.bias, eps=1e-5)


def _conv_param(k: int, cin: int, cout: int) -> nn.Parameter:
    return nn.Parameter(torch.empty(cout, cin, k, k))


class BasicBlock(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int):
        super().__init__()
        self.stride = stride
        self.conv1, self.gn1 = _conv_param(3, cin, cout), GroupNorm(cout)
        self.conv2, self.gn2 = _conv_param(3, cout, cout), GroupNorm(cout)
        self.has_proj = stride != 1 or cin != cout
        if self.has_proj:
            self.proj, self.gn_proj = _conv_param(1, cin, cout), GroupNorm(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.gn1(_conv(x, self.conv1, self.stride)))
        h = self.gn2(_conv(h, self.conv2))
        sc = self.gn_proj(_conv(x, self.proj, self.stride)) \
            if self.has_proj else x
        return F.relu(h + sc)


class Bottleneck(nn.Module):
    def __init__(self, cin: int, cmid: int, stride: int):
        super().__init__()
        cout = cmid * 4
        self.stride = stride
        self.conv1, self.gn1 = _conv_param(1, cin, cmid), GroupNorm(cmid)
        self.conv2, self.gn2 = _conv_param(3, cmid, cmid), GroupNorm(cmid)
        self.conv3, self.gn3 = _conv_param(1, cmid, cout), GroupNorm(cout)
        self.has_proj = stride != 1 or cin != cout
        if self.has_proj:
            self.proj, self.gn_proj = _conv_param(1, cin, cout), GroupNorm(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.gn1(_conv(x, self.conv1)))
        h = F.relu(self.gn2(_conv(h, self.conv2, self.stride)))
        h = self.gn3(_conv(h, self.conv3))
        sc = self.gn_proj(_conv(x, self.proj, self.stride)) \
            if self.has_proj else x
        return F.relu(h + sc)


class ResNetModule(nn.Module):
    """The network; its parameter names are the tree's dotted paths."""

    def __init__(self, cfg: ResNetConfig):
        super().__init__()
        self.stem = _conv_param(3, cfg.in_channels, cfg.width)
        self.gn_stem = GroupNorm(cfg.width)
        stages = []
        cin = cfg.width
        for si, nblocks in enumerate(cfg.stage_blocks):
            cmid = cfg.width * (2 ** si)
            blocks = []
            for bi in range(nblocks):
                stride = 2 if (bi == 0 and si > 0) else 1
                if cfg.block == "basic":
                    blocks.append(BasicBlock(cin, cmid, stride))
                    cin = cmid
                else:
                    blocks.append(Bottleneck(cin, cmid, stride))
                    cin = cmid * 4
            stages.append(nn.ModuleList(blocks))
        self.stages = nn.ModuleList(stages)
        self.head = nn.Parameter(torch.empty(cin, cfg.num_classes))
        self.head_b = nn.Parameter(torch.zeros(cfg.num_classes))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images (B, H, W, C) -> logits (B, num_classes)."""
        x = images.permute(0, 3, 1, 2).contiguous()
        x = F.relu(self.gn_stem(_conv(x, self.stem)))
        for stage in self.stages:
            for block in stage:
                x = block(x)
        x = x.mean(dim=(2, 3))
        return x @ self.head + self.head_b


def _init_tree(module: nn.Module, gen: torch.Generator,
               device: torch.device) -> Dict[str, Any]:
    """He-normal convs, unit/zero GroupNorm, a cin^-1/2 normal head —
    the JAX package's init distributions (not its random bits)."""
    named = []
    for name, p in module.named_parameters():
        if p.dim() == 4:
            _, cin, k, _ = p.shape
            v = torch.randn(p.shape, generator=gen) * (2.0 / (k * k * cin)) ** 0.5
        elif name == "head":
            v = torch.randn(p.shape, generator=gen) * p.shape[0] ** -0.5
        elif name.endswith("scale"):
            v = torch.ones(p.shape)
        else:
            v = torch.zeros(p.shape)
        named.append((name, v.to(device)))
    return tree_from_named(named)


class ResNet:
    """Functional face of :class:`ResNetModule`: the JAX package's
    ``init`` / ``apply`` / ``loss`` on a parameter tree of tensors."""

    def __init__(self, cfg: ResNetConfig):
        self.cfg = cfg
        # the module only names the computation: functional_call swaps
        # in the caller's tensors, so its own parameters never allocate
        with torch.device("meta"):
            self.module = ResNetModule(cfg)

    def init(self, seed: int = 0, device: Any = None) -> Dict[str, Any]:
        """Random params from ``seed`` on ``device`` (None: the card)."""
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        return _init_tree(self.module, gen, dev)

    def apply(self, params: Dict[str, Any], images: torch.Tensor
              ) -> torch.Tensor:
        """images: (B, H, W, C) -> logits (B, num_classes)."""
        return functional_call(self.module, dict(named_leaves(params)),
                               (images,))

    def loss(self, params: Dict[str, Any], batch: Dict[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        logits = self.apply(params, batch["images"])
        labels = batch["labels"].long()
        logz = torch.logsumexp(logits, dim=-1)
        tok = torch.gather(logits, -1, labels[:, None])[:, 0]
        loss = (logz - tok).mean()
        acc = (logits.argmax(-1) == labels).float().mean()
        return loss, {"accuracy": acc}


def build_resnet(cfg: ResNetConfig) -> ResNet:
    return ResNet(cfg)
