"""Convert a torchvision resnet18/34 checkpoint to the encoder npz format.

The reference's CustomUNet/DeepLab default to ImageNet-pretrained
encoders (reference: config/CLI/model/customunet.yaml
``encoder_weights``). This environment cannot download them, so the user
supplies a torchvision state_dict file (resnet18-f37072fd.pth /
resnet34-b627a593.pth) and this converts it, with ``torch.load`` alone
(torchvision is not needed):

- conv kernels OIHW → HWIO,
- BatchNorm running stats folded into affine (frozen-BN) scale/bias, so
  the converted encoder reproduces torchvision EVAL outputs exactly —
  use it with ``encoder_norm: affine``.

Usage:
    python -m py4cast_tpu_torch.tools.convert_torchvision_encoder resnet18.pth \\
        --encoder resnet18 [--out PATH]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from py4cast_tpu_torch.models.pretrained import default_weights_path, save_encoder_npz
from py4cast_tpu_torch.models.unet import _RESNET_STAGES

BN_EPS = 1e-5


def fold_bn(sd: dict, prefix: str):
    """A BatchNorm's (scale, bias) with its running statistics folded in."""
    w = sd[f"{prefix}.weight"].numpy()
    b = sd[f"{prefix}.bias"].numpy()
    mean = sd[f"{prefix}.running_mean"].numpy()
    var = sd[f"{prefix}.running_var"].numpy()
    scale = w / np.sqrt(var + BN_EPS)
    return scale.astype(np.float32), (b - mean * scale).astype(np.float32)


def conv_kernel(sd: dict, key: str) -> np.ndarray:
    return sd[key].numpy().transpose(2, 3, 1, 0).astype(np.float32)  # OIHW→HWIO


def convert(state_dict: dict, encoder_name: str) -> dict:
    """The encoder npz's flat arrays of a torchvision ResNet state dict."""
    blocks, _ = _RESNET_STAGES[encoder_name]
    flat = {"stem_conv/kernel": conv_kernel(state_dict, "conv1.weight")}
    flat["stem_norm/scale"], flat["stem_norm/bias"] = fold_bn(state_dict, "bn1")
    for stage, n_blocks in enumerate(blocks):
        for b in range(n_blocks):
            t = f"layer{stage + 1}.{b}"
            o = f"stage{stage}_block{b}"
            for conv, norm in (("conv1", "norm1"), ("conv2", "norm2")):
                flat[f"{o}/{conv}/kernel"] = conv_kernel(state_dict, f"{t}.{conv}.weight")
                flat[f"{o}/{norm}/scale"], flat[f"{o}/{norm}/bias"] = fold_bn(
                    state_dict, f"{t}.bn{conv[-1]}")
            if f"{t}.downsample.0.weight" in state_dict:
                flat[f"{o}/proj/kernel"] = conv_kernel(state_dict, f"{t}.downsample.0.weight")
                flat[f"{o}/proj_norm/scale"], flat[f"{o}/proj_norm/bias"] = fold_bn(
                    state_dict, f"{t}.downsample.1")
    return flat


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("checkpoint", type=Path)
    parser.add_argument("--encoder", default="resnet18", choices=sorted(_RESNET_STAGES))
    parser.add_argument("--out", type=Path, default=None)
    args = parser.parse_args(argv)

    sd = torch.load(args.checkpoint, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    flat = convert(sd, args.encoder)
    out = args.out or default_weights_path(args.encoder)
    save_encoder_npz(out, flat, {"encoder_name": args.encoder, "norm": "affine",
                                 "in_channels": 3, "source": "torchvision"})
    print(f"Wrote {len(flat)} arrays to {out} (use encoder_norm: affine)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
