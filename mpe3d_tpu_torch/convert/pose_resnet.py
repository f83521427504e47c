"""PoseResNet-50, the conversor's 2D heatmap detector.

Port of ``mpe3d_tpu/convert/pose_resnet.py`` (``apply_pose_resnet`` :89,
``init_pose_resnet`` :116, ``load_torch_pose_resnet`` :159): the
simple-baselines model the reference's conversor runs
(panoptic_conversor/pose_resnet.py:100-233): a ResNet-50 trunk, 3 x
ConvTranspose(256, k4, s2, p1) + BN + ReLU, a 1x1 convolution to 18
heatmaps at a quarter of the input's resolution.

The module's parameter names are simple-baselines' (``conv1``, ``bn1``,
``layer{1-4}.{i}.{conv,bn}{1-3}``, ``layer{1-4}.0.downsample.{0,1}``,
``deconv_layers.{0,1,3,4,6,7}``, ``final_layer``), so the reference's
``pose_resnet50_panoptic.pth.tar`` loads with ``load_state_dict(strict=
True)`` once DataParallel's ``module.`` prefix is stripped
(``load_pose_resnet_checkpoint``).  Inference only: batch norm in eval
form (running statistics, eps 1e-5).

Padding: the stride-2 convolutions pad symmetrically, (3, 3) for the 7x7
``conv1`` and (1, 1) for the 3x3 ones, as the checkpoint's model does.
The JAX package pads them with XLA's "SAME", (2, 3) and (0, 1) on even
inputs, which shifts every stride-2 window by one pixel (a defect of the
JAX package, ROADMAP.md section 3); its tests hold this module to JAX with
the JAX convolution's padding made symmetric.

The convolutions are ``torch.nn.functional.conv2d`` / ``conv_transpose2d``
(cuDNN on the card), as the JAX package computes them with
``lax.conv_general_dilated`` / ``conv_transpose`` outside any Pallas
kernel.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

RESNET50_BLOCKS = (3, 4, 6, 3)
STAGE_WIDTHS = (64, 128, 256, 512)
EXPANSION = 4
DECONV_FILTERS = 256
N_DECONV = 3
N_JOINTS = 18


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (the stride) -> 1x1 with a projection shortcut on the
    first block of a stage."""

    def __init__(self, cin: int, width: int, stride: int, project: bool):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, width, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(width)
        self.conv2 = nn.Conv2d(width, width, 3, stride, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(width)
        self.conv3 = nn.Conv2d(width, width * EXPANSION, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(width * EXPANSION)
        self.downsample = (nn.Sequential(
            nn.Conv2d(cin, width * EXPANSION, 1, stride, bias=False),
            nn.BatchNorm2d(width * EXPANSION)) if project else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        idn = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + idn)


class PoseResNet(nn.Module):
    """PoseResNet-50: [N, 3, H, W] normalised images -> [N, 18, H/4, W/4]
    heatmaps."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        cin = 64
        for li, (n, width) in enumerate(zip(RESNET50_BLOCKS, STAGE_WIDTHS)):
            blocks = []
            for bi in range(n):
                stride = 2 if (li > 0 and bi == 0) else 1
                blocks.append(Bottleneck(cin, width, stride, bi == 0))
                cin = width * EXPANSION
            setattr(self, f"layer{li + 1}", nn.Sequential(*blocks))
        dec = []
        for _ in range(N_DECONV):
            dec += [nn.ConvTranspose2d(cin, DECONV_FILTERS, 4, 2, 1,
                                       bias=False),
                    nn.BatchNorm2d(DECONV_FILTERS), nn.ReLU()]
            cin = DECONV_FILTERS
        self.deconv_layers = nn.Sequential(*dec)
        self.final_layer = nn.Conv2d(cin, N_JOINTS, 1)
        self.eval()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.maxpool(torch.relu(self.bn1(self.conv1(x))))
        for li in range(len(RESNET50_BLOCKS)):
            x = getattr(self, f"layer{li + 1}")(x)
        return self.final_layer(self.deconv_layers(x))


def _out_hw(m: nn.Module, hw: Tuple[int, int]) -> Tuple[int, int]:
    k, st, p = (v if isinstance(v, int) else v[0]
                for v in (m.kernel_size, m.stride, m.padding))
    if isinstance(m, nn.ConvTranspose2d):
        return tuple((s - 1) * st - 2 * p + k for s in hw)
    return tuple((s + 2 * p - k) // st + 1 for s in hw)


def pose_resnet_flops(net: PoseResNet, hw: Tuple[int, int]) -> int:
    """Floating-point operations (2 a multiply-add) of the convolutions of
    one forward pass of ``net`` on an (H, W) image."""
    def conv(m, h_in):
        kh, kw = m.kernel_size
        # a transposed convolution scatters a kh x kw patch an input pixel
        n = h_in if isinstance(m, nn.ConvTranspose2d) else _out_hw(m, h_in)
        return 2 * m.in_channels * m.out_channels * kh * kw * n[0] * n[1]

    total = conv(net.conv1, hw)
    hw = _out_hw(net.maxpool, _out_hw(net.conv1, hw))
    for li in range(len(RESNET50_BLOCKS)):
        for blk in getattr(net, f"layer{li + 1}"):
            h2 = _out_hw(blk.conv2, hw)
            total += conv(blk.conv1, hw) + conv(blk.conv2, hw) \
                + conv(blk.conv3, h2)
            if blk.downsample is not None:
                total += conv(blk.downsample[0], hw)
            hw = h2
    for m in net.deconv_layers:
        if isinstance(m, nn.ConvTranspose2d):
            total += conv(m, hw)
            hw = _out_hw(m, hw)
    return total + conv(net.final_layer, hw)


def he_normal_state(seed: int) -> Dict[str, np.ndarray]:
    """A numpy-seeded He-normal state dict (float32) of ``PoseResNet``:
    the distribution of the JAX ``init_pose_resnet`` (std sqrt(2 / (kh kw
    cin)), with the JAX layout's cin for the deconvolutions, i.e. their
    256 output channels), identity batch norm, a zero head bias.  JAX's
    ``PRNGKey`` draws cannot be reproduced, so a random backbone is good
    for layout and speed checks only."""
    rng = np.random.default_rng(seed)
    state = {}
    for name, t in PoseResNet().state_dict().items():
        shape = tuple(t.shape)
        if name.endswith("num_batches_tracked"):
            state[name] = np.zeros((), np.int64)
        elif name.endswith("running_var") or (
                name.endswith(".weight") and len(shape) == 1):
            state[name] = np.ones(shape, np.float32)
        elif len(shape) == 4:
            # [Cout, Cin, kh, kw] (conv) or [Cin, 256, kh, kw] (deconv)
            fan = shape[1] * shape[2] * shape[3]
            state[name] = (rng.standard_normal(shape)
                           * np.sqrt(2.0 / fan)).astype(np.float32)
        else:
            state[name] = np.zeros(shape, np.float32)
    return state


def load_pose_resnet_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """The state dict of a simple-baselines / VoxelPose checkpoint
    (``pose_resnet50_panoptic.pth.tar``: ``{"state_dict": ...}`` or the
    bare dict, DataParallel's ``module.`` prefix stripped).  The file is a
    pickle: load only a checkpoint from a source you trust."""
    raw = torch.load(path, map_location="cpu", weights_only=False)
    state = raw.get("state_dict", raw)
    return {k.replace("module.", ""): v for k, v in state.items()}


def pose_resnet(state, device="cuda") -> PoseResNet:
    """A ``PoseResNet`` in eval mode on ``device`` holding ``state`` (a
    state dict of tensors or numpy arrays, loaded strictly)."""
    net = PoseResNet()
    net.load_state_dict({k: torch.as_tensor(np.asarray(v)) if not
                         torch.is_tensor(v) else v
                         for k, v in state.items()}, strict=True)
    return net.to(device).eval()
