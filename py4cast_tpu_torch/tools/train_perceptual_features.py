"""Train the perceptual loss's feature extractor and save its weights.

The reference's PerceptualLoss wraps a pretrained VGG16 (reference:
py4cast/losses.py:213-260 via mfai); pretrained torchvision weights are
not downloadable here, so this trains a small convolutional encoder
from scratch as a denoising autoencoder on synthetic Gaussian random
fields (smooth multi-scale textures, the statistics of weather fields)
and ships the encoder as the perceptual feature pyramid
(``py4cast_tpu_torch/data/perceptual_feats.npz``, which
``losses.PerceptualLossPy4Cast`` reads). The initial weights, the
fields and the noise are all drawn from ``np.random.default_rng(seed)``
in the JAX package's order, so a seed gives the JAX tool's trajectory.

Usage:
    python -m py4cast_tpu_torch.tools.train_perceptual_features [--steps 800] \\
        [--out PATH] [--device cuda]
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from py4cast_tpu_torch.losses import PERCEPTUAL_FEATS
from py4cast_tpu_torch.tools.pretrain_encoder import noisy_batches
from py4cast_tpu_torch.utils import exact_reductions, resolve_device

#: encoder layout: (in_ch, out_ch) per 3x3 conv scale
LAYERS = [(1, 16), (16, 32), (32, 32)]


def init_params(rng: np.random.Generator) -> Dict[str, np.ndarray]:
    """The encoder's HWIO kernels and zero biases (``k{i}``, ``b{i}``),
    then the mirrored decoder's (``dk{i}``, ``db{i}``, discarded after
    training), each kernel a normal over sqrt(9·in)."""
    p = {}
    for i, (cin, cout) in enumerate(LAYERS):
        p[f"k{i}"] = (rng.standard_normal((3, 3, cin, cout)) / np.sqrt(9 * cin)).astype(np.float32)
        p[f"b{i}"] = np.zeros(cout, np.float32)
    for i, (cout, cin) in enumerate(reversed(LAYERS)):
        p[f"dk{i}"] = (rng.standard_normal((3, 3, cin, cout)) / np.sqrt(9 * cin)).astype(np.float32)
        p[f"db{i}"] = np.zeros(cout, np.float32)
    return p


def conv(x: torch.Tensor, k: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A 3x3 SAME conv of NHWC ``x`` with an HWIO kernel, plus bias."""
    y = F.conv2d(x.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1), b, padding=1)
    return y.permute(0, 2, 3, 1)


def encode(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """The code under the feature pyramid: per scale a conv and ReLU,
    then a [::2, ::2] subsample."""
    h = x
    for i in range(len(LAYERS)):
        h = F.relu(conv(h, p[f"k{i}"], p[f"b{i}"]))[:, ::2, ::2, :]
    return h


def decode(p: Dict[str, torch.Tensor], h: torch.Tensor) -> torch.Tensor:
    for i in range(len(LAYERS)):
        h = h.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
        h = conv(h, p[f"dk{i}"], p[f"db{i}"])
        if i < len(LAYERS) - 1:
            h = F.relu(h)
    return h


def train(steps: int = 800, batch: int = 32, seed: int = 0, device="cuda",
          log=print) -> Tuple[Dict[str, torch.Tensor], List[float]]:
    """Train the autoencoder ``steps`` Adam steps (optax.adam(1e-3)'s
    defaults) on ``device`` (the card unless asked for the CPU), each
    inside ``exact_reductions``; every parameter and every step's loss.
    Logs the loss every 100 steps and at the last."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    params = {k: torch.from_numpy(v).to(dev).requires_grad_(True)
              for k, v in init_params(rng).items()}
    opt = torch.optim.Adam(params.values(), lr=1e-3, betas=(0.9, 0.999), eps=1e-8)
    losses = []
    for i, (noisy, clean) in enumerate(noisy_batches(rng, steps, batch, 64, channels=1)):
        with exact_reductions():
            opt.zero_grad(set_to_none=True)
            code = encode(params, torch.from_numpy(noisy).to(dev))
            loss = torch.mean((decode(params, code) - torch.from_numpy(clean).to(dev)) ** 2)
            loss.backward()
            opt.step()
        losses.append(loss.detach())
        if i % 100 == 0 or i == steps - 1:
            log(f"step {i}: denoise mse {float(losses[-1]):.4f}")
    return {k: v.detach() for k, v in params.items()}, torch.stack(losses).tolist()


def save_features(params: Dict[str, torch.Tensor], out: Path) -> Path:
    """Write the encoder's parameters (not the decoder's) as the
    perceptual features' npz."""
    out = Path(out)
    out.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(out, **{k: v.cpu().numpy() for k, v in params.items()
                                if not k.startswith(("dk", "db"))})
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--steps", type=int, default=800)
    parser.add_argument("--batch", type=int, default=32)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", type=Path, default=PERCEPTUAL_FEATS)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    params, _ = train(args.steps, args.batch, args.seed, args.device)
    out = save_features(params, args.out)
    print(f"Saved encoder ({out.stat().st_size / 1024:.0f} KB) to {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
