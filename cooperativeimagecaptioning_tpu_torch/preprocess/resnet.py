"""ResNet family for offline feature extraction, as PyTorch modules
(counterpart of the JAX package's preprocess/resnet.py; ref: misc/resnet.py,
misc/resnet_utils.py, preprocess/prepro_feats.py).

Keeps the reference's two deviations from stock torchvision:
  1. the 1x1 conv1 of each Bottleneck carries the stride (misc/resnet.py:62-63);
  2. the stem's max pool is MaxPool2d(3, 2, padding=0, ceil_mode=True)
     (misc/resnet.py:105-106).

Modules and parameters are named as torchvision names them, so a torchvision
(or reference) `state_dict` loads with `load_state_dict` (`load_weights`).
Inference only: batch norm runs in eval mode on its stored statistics.  The
convolutions are `F.conv2d` (cuDNN on the card), as the JAX package computes
them with `lax.conv_general_dilated` outside any Pallas kernel.

Layouts: the JAX package is NHWC / HWIO; here the model is NCHW / OIHW.
`features` takes NHWC images, as the JAX function does, and hands the
network their NCHW view, which has channels_last strides (no copy): the
convolutions follow the input's memory format, so cuDNN runs its NHWC
kernels.  Converting the weights to channels_last as well changed the
forward by under 1% on an H100, so they stay as loaded.
`att` comes back NHWC, [B, att, att, 2048], which is the layout the feature
files hold.  `params_from_jax` carries a JAX parameter tree (HWIO) over as
this model's `state_dict` (OIHW).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

LAYER_SPECS = {
    "resnet50": (3, 4, 6, 3),
    "resnet101": (3, 4, 23, 3),
    "resnet152": (3, 8, 36, 3),
}

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


class Bottleneck(nn.Module):
    """ref: misc/resnet.py:56-93 -- the stride on the 1x1 conv1 (deviation
    #1)."""

    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, stride=stride, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(planes * 4)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = downsample

    def forward(self, x):
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        residual = x if self.downsample is None else self.downsample(x)
        return self.relu(out + residual)


class ResNet(nn.Module):
    """Stem + four stages (+ torchvision's unused classifier `fc`, so that a
    torchvision state_dict loads whole)."""

    def __init__(self, blocks, num_classes=1000):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(3, 2, padding=0, ceil_mode=True)
        inplanes = 64
        for li, n_blocks in enumerate(blocks):
            planes = 64 * 2 ** li
            stride = 1 if li == 0 else 2
            down = nn.Sequential(
                nn.Conv2d(inplanes, planes * 4, 1, stride=stride, bias=False),
                nn.BatchNorm2d(planes * 4))
            layer = [Bottleneck(inplanes, planes, stride, down)]
            layer += [Bottleneck(planes * 4, planes)
                      for _ in range(n_blocks - 1)]
            setattr(self, f"layer{li + 1}", nn.Sequential(*layer))
            inplanes = planes * 4
        self.fc = nn.Linear(inplanes, num_classes)

    def forward(self, x):
        """NCHW normalized images -> the layer4 map [B, 2048, ~H/32, ~W/32]."""
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        return self.layer4(self.layer3(self.layer2(self.layer1(x))))


def features(model, images, att_size=14):
    """myResnet head (ref: misc/resnet_utils.py:11-28).

    images: [B, H, W, 3] already normalized.  Returns (fc [B, 2048], att
    [B, att_size, att_size, 2048]): fc the spatial mean of the layer4 map,
    att its adaptive average pool, NHWC."""
    x = model(images.permute(0, 3, 1, 2))
    fc = x.mean(dim=(2, 3))
    att = F.adaptive_avg_pool2d(x, (att_size, att_size))
    return fc, att.permute(0, 2, 3, 1)


def preprocess_images(images_uint8):
    """raw uint8 [B, H, W, 3] -> normalized float (ref: prepro_feats.py:75-87)."""
    x = images_uint8.to(torch.float32) / 255.0
    mean = torch.as_tensor(IMAGENET_MEAN, device=x.device)
    std = torch.as_tensor(IMAGENET_STD, device=x.device)
    return (x - mean) / std


# -- params -----------------------------------------------------------------

def _blocks_of(arch):
    return arch if isinstance(arch, (tuple, list)) else LAYER_SPECS[arch]


def init_model(generator, arch="resnet101"):
    """A ResNet in eval mode, its convolutions drawn from `generator` (a
    torch.Generator) at the JAX package's He scale, normal * sqrt(2 / (k * k
    * cout)); batch norms are the identity (scale 1, bias 0, mean 0, var 1).
    The JAX package's draws cannot be reproduced here: `params_from_jax`
    carries its weights over instead."""
    model = ResNet(_blocks_of(arch))
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                k, cout = m.kernel_size[0], m.out_channels
                m.weight.copy_(torch.randn(m.weight.shape,
                                           generator=generator)
                               * np.sqrt(2.0 / (k * k * cout)))
    return model.eval()


def load_weights(model, state_dict):
    """Load a torchvision / reference state_dict (or `params_from_jax`'s)
    into `model`; only the unused classifier `fc` may be missing.  Returns
    the model in eval mode."""
    sd = {k: torch.as_tensor(np.asarray(v)) for k, v in state_dict.items()}
    missing, unexpected = model.load_state_dict(sd, strict=False)
    bad = [k for k in missing if not k.startswith("fc.")]
    if bad or unexpected:
        raise KeyError(f"state_dict does not fit the model: missing {bad}, "
                       f"unexpected {unexpected}")
    return model.eval()


def params_from_jax(tree):
    """The JAX package's parameter tree (numpy arrays; conv weights HWIO) ->
    this model's state_dict (OIHW), without the classifier `fc`."""
    sd = {}

    def conv(name, p):
        sd[name + ".weight"] = torch.from_numpy(
            np.ascontiguousarray(np.asarray(p["w"]).transpose(3, 2, 0, 1)))

    def bn(prefix, p):
        for ours, theirs in (("weight", "scale"), ("bias", "bias"),
                             ("running_mean", "mean"),
                             ("running_var", "var")):
            sd[f"{prefix}.{ours}"] = torch.from_numpy(
                np.array(p[theirs], np.float32))

    conv("conv1", tree["conv1"])
    bn("bn1", tree["bn1"])
    for li in range(4):
        for bi, bp in enumerate(tree[f"layer{li + 1}"]):
            pre = f"layer{li + 1}.{bi}"
            for j in (1, 2, 3):
                conv(f"{pre}.conv{j}", bp[f"conv{j}"])
                bn(f"{pre}.bn{j}", bp[f"bn{j}"])
            if "downsample" in bp:
                conv(f"{pre}.downsample.0", bp["downsample"]["conv"])
                bn(f"{pre}.downsample.1", bp["downsample"]["bn"])
    return sd


def f32_convolutions():
    """A context in which cuDNN computes float32 convolutions in float32:
    PyTorch lets cuDNN use TF32 for them by default, which moves a
    ResNet-101 feature by ~1e-3 relative against the CPU.  Only TF32 is
    switched off, and only inside the context (the global flag stays as
    other code set it)."""
    cudnn = torch.backends.cudnn
    return cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                       deterministic=cudnn.deterministic, allow_tf32=False)
