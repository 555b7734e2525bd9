"""Self-supervised offline pretraining of the ResNet encoder of
CustomUNet, DeepLabV3 and DeepLabV3Plus.

Zero-egress substitute for ImageNet encoder weights (reference:
config/CLI/model/customunet.yaml ``encoder_weights``): trains the port's
``ResNetEncoder`` as a denoising autoencoder on synthetic power-law
random fields (multi-scale textures with weather-field statistics) and
saves the encoder in the npz format ``encoder_weights: true`` loads
(``models/pretrained.py``), the JAX package's format, so one file serves
both packages. The fields and the noise come from
``np.random.default_rng(seed)`` in the JAX package's order, the initial
weights from a ``torch.Generator`` seeded with ``seed``.

Usage:
    python -m py4cast_tpu_torch.tools.pretrain_encoder [--encoder resnet18] \\
        [--steps 500] [--size 64] [--out PATH] [--device cuda]
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Deque, Iterator, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from py4cast_tpu_torch.convert import encoder_to_flax
from py4cast_tpu_torch.models.base import FlaxConv2d, GroupNorm
from py4cast_tpu_torch.models.pretrained import default_weights_path, save_encoder_npz
from py4cast_tpu_torch.models.unet import _RESNET_STAGES, ResNetEncoder
from py4cast_tpu_torch.training import init_weights
from py4cast_tpu_torch.utils import exact_reductions, resolve_device

#: the npz's meta beside the encoder's name
META = {"norm": "group", "in_channels": 3, "source": "selfsupervised-grf"}


def draw_fields(rng: np.random.Generator, n: int, size: int,
                channels: int = 3) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """What ``n`` fields draw from ``rng``, in the JAX tools' order: each
    field's spectral slope, then the real and imaginary parts of its
    phases."""
    alpha = rng.uniform(1.5, 3.5, size=(n, channels, 1, 1))
    re = rng.standard_normal((n, channels, size, size))
    im = rng.standard_normal((n, channels, size, size))
    return alpha, re, im


def fields(alpha: np.ndarray, re: np.ndarray, im: np.ndarray) -> np.ndarray:
    """(n, size, size, channels) float32 fields with a power-law spectrum
    of slope ``alpha`` (n, channels, 1, 1) and phases ``re + 1j·im``, each
    standardized: the multi-scale smooth textures weather fields are made
    of."""
    size = re.shape[-1]
    k = np.fft.fftfreq(size)[:, None] ** 2 + np.fft.fftfreq(size)[None, :] ** 2
    k = np.sqrt(k) + 1e-6
    spectrum = k[None, None] ** (-alpha / 2.0)
    phases = re + 1j * im
    out = np.fft.ifft2(spectrum * phases).real
    out -= out.mean(axis=(2, 3), keepdims=True)
    out /= out.std(axis=(2, 3), keepdims=True) + 1e-8
    return np.moveaxis(out, 1, -1).astype(np.float32)


def gaussian_random_fields(rng: np.random.Generator, n: int, size: int,
                           channels: int = 3) -> np.ndarray:
    """``fields`` drawn from ``rng``, as the JAX tools draw them."""
    return fields(*draw_fields(rng, n, size, channels))


class _InOrder:
    """Step i's draws from one generator, made only after step i − 1's,
    whichever thread asks first."""

    def __init__(self, rng: np.random.Generator, n: int, size: int, channels: int):
        self.rng, self.shape = rng, (n, size, channels)
        self.turn = 0
        self.cond = threading.Condition()

    def batch(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        n, size, channels = self.shape
        with self.cond:
            self.cond.wait_for(lambda: self.turn == i)
            try:
                drawn = draw_fields(self.rng, n, size, channels)
                noise = self.rng.standard_normal((n, size, size, channels)).astype(np.float32)
            finally:  # a failed draw still lets the next step's thread go
                self.turn += 1
                self.cond.notify_all()
        clean = fields(*drawn)
        return clean + 0.3 * noise, clean


def noisy_batches(rng: np.random.Generator, steps: int, n: int, size: int,
                  channels: int = 3, workers: int = 4) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """(noisy, clean) of each of ``steps`` steps: clean fields and the
    noise 0.3·N(0, 1) on them, the numbers drawn from ``rng`` step after
    step in the JAX tool's order (the same bits as drawing them in one
    thread). The fields' FFTs, which release the interpreter lock, run
    on ``workers`` threads up to ``workers`` steps ahead of the caller,
    so that the draws overlap the card's steps."""
    draws = _InOrder(rng, n, size, channels)
    with ThreadPoolExecutor(workers) as pool:
        ahead: Deque = collections.deque()
        try:
            for i in range(steps):
                ahead.append(pool.submit(draws.batch, i))
                if len(ahead) > workers:
                    yield ahead.popleft().result()
            while ahead:
                yield ahead.popleft().result()
        finally:
            # a step not started yet is dropped; one started waits on no
            # dropped step (the pool starts them in order)
            pool.shutdown(cancel_futures=True)


def resize_nearest(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """NHWC ``x`` resized to (h, w) as ``jax.image.resize(method=
    "nearest")`` resizes: output i reads input floor((i + 0.5)·m / n),
    computed in float32. A whole-factor growth repeats each row and
    column, whose backward sums in a fixed order."""
    for dim, n in ((1, h), (2, w)):
        m = x.shape[dim]
        if n == m:
            continue
        if n % m == 0:
            x = x.repeat_interleave(n // m, dim=dim)
        else:
            src = (torch.arange(n, dtype=torch.float32, device=x.device) + 0.5) * m / n
            x = x.index_select(dim, torch.floor(src).long())
    return x


class DenoiseAE(nn.Module):
    """The ResNet encoder under a UNet-style decoder with skip
    connections: from the deepest map up, a nearest growth to the skip,
    the skip concatenated, a 3x3 conv to 64, GroupNorm(8) and GELU (tanh);
    then a nearest growth to the input, a 3x3 conv to 32, GroupNorm(8),
    GELU and a 1x1 conv to the input's channels. A plain bottleneck
    decoder collapses to the field's mean and trains the encoder nothing;
    the skips make every stage carry features the downstream models use.
    Modules carry Flax's auto names (``Conv_0``, ``GroupNorm_0``), so
    ``convert.params_from_jax`` maps the JAX tool's variables one to
    one."""

    def __init__(self, encoder_name: str, in_channels: int = 3, depth: int = 5):
        super().__init__()
        self.encoder = ResNetEncoder(in_channels, encoder_name, depth)
        channels = self.encoder.channels
        self.num_up = len(channels) - 1
        y_ch = channels[-1]
        for i, skip in enumerate(reversed(channels[:-1])):
            self.add_module(f"Conv_{i}", FlaxConv2d(y_ch + skip, 64, 3))
            self.add_module(f"GroupNorm_{i}", GroupNorm(8, 64))
            y_ch = 64
        self.add_module(f"Conv_{self.num_up}", FlaxConv2d(64, 32, 3))
        self.add_module(f"GroupNorm_{self.num_up}", GroupNorm(8, 32))
        self.add_module(f"Conv_{self.num_up + 1}", FlaxConv2d(32, in_channels, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats = self.encoder(x)
        y = feats[-1]
        for i, skip in enumerate(reversed(feats[:-1])):
            y = torch.cat([resize_nearest(y, skip.shape[1], skip.shape[2]), skip], dim=-1)
            y = F.gelu(getattr(self, f"GroupNorm_{i}")(getattr(self, f"Conv_{i}")(y)),
                       approximate="tanh")
        y = resize_nearest(y, x.shape[1], x.shape[2])
        n = self.num_up
        y = F.gelu(getattr(self, f"GroupNorm_{n}")(getattr(self, f"Conv_{n}")(y)),
                   approximate="tanh")
        return getattr(self, f"Conv_{n + 1}")(y)


def build(encoder_name: str, seed: int, device) -> DenoiseAE:
    """The autoencoder with Flax's initializers drawn from a CPU
    ``torch.Generator`` seeded with ``seed`` (the same weights on every
    device), then moved to ``device``."""
    model = DenoiseAE(encoder_name)
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(device)


def adam(model: nn.Module) -> torch.optim.Adam:
    """optax.adam(1e-3): b1 0.9, b2 0.999, eps 1e-8 outside the root; on
    the card its step count lives on the device, so that a CUDA graph
    can replay the step."""
    on_card = next(model.parameters()).device.type == "cuda"
    return torch.optim.Adam(model.parameters(), lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                            capturable=on_card)


def train_step(model: nn.Module, opt: torch.optim.Optimizer, noisy: torch.Tensor,
               clean: torch.Tensor) -> torch.Tensor:
    """One Adam step on the denoising MSE, inside ``exact_reductions``;
    the loss before the step."""
    with exact_reductions():
        opt.zero_grad(set_to_none=True)
        loss = torch.mean((model(noisy) - clean) ** 2)
        loss.backward()
        opt.step()
    return loss.detach()


class GraphedStep:
    """``train_step`` on the card, captured once as a CUDA graph and
    replayed a step: the same kernels, without the host's cost of
    launching them (a ResNet34 step at batch 16, 64x64, is host-bound).
    Each call copies the batch into the graph's input buffers; the loss
    comes back in a tensor of its own."""

    def __init__(self, model: nn.Module, opt: torch.optim.Optimizer, shape, device):
        self.noisy = torch.empty(shape, device=device)
        self.clean = torch.empty(shape, device=device)
        self.graph = torch.cuda.CUDAGraph()
        opt.zero_grad(set_to_none=True)  # the capture's backward makes the grads
        with exact_reductions(), torch.cuda.graph(self.graph):
            self.loss = torch.mean((model(self.noisy) - self.clean) ** 2)
            self.loss.backward()
            opt.step()

    def __call__(self, noisy: torch.Tensor, clean: torch.Tensor) -> torch.Tensor:
        self.noisy.copy_(noisy)
        self.clean.copy_(clean)
        self.graph.replay()
        return self.loss.detach().clone()


#: steps run eagerly before the card's step is captured (and the warm-up
#: that capturing asks for: cuDNN's and cuBLAS's handles, autograd)
EAGER_STEPS = 3


def pretrain(encoder_name: str = "resnet18", steps: int = 500, batch: int = 16,
             size: int = 64, seed: int = 0, device="cuda",
             log=print) -> Tuple[DenoiseAE, List[float]]:
    """Train the autoencoder ``steps`` steps on ``device`` (the card
    unless asked for the CPU); the model and every step's loss. Logs the
    loss every 100 steps and at the last. On the card the first
    EAGER_STEPS steps run eagerly on a side stream, the rest as replays
    of a ``GraphedStep``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    model = build(encoder_name, seed, dev)
    opt = adam(model)
    losses, graphed = [], None
    side = torch.cuda.Stream(dev) if dev.type == "cuda" else None
    if side is not None:
        side.wait_stream(torch.cuda.current_stream(dev))
    for i, (noisy, clean) in enumerate(noisy_batches(rng, steps, batch, size)):
        x, y = torch.from_numpy(noisy), torch.from_numpy(clean)
        eager = side is None or i < EAGER_STEPS
        if graphed is None and not eager:
            torch.cuda.current_stream(dev).wait_stream(side)
            graphed = GraphedStep(model, opt, x.shape, dev)
        with torch.cuda.stream(side) if eager and side is not None else contextlib.nullcontext():
            losses.append(train_step(model, opt, x.to(dev), y.to(dev)) if eager else graphed(x, y))
            if i % 100 == 0 or i == steps - 1:
                log(f"step {i}: denoise mse {float(losses[-1]):.4f}")
    if side is not None:
        torch.cuda.current_stream(dev).wait_stream(side)
    return model, torch.stack(losses).tolist()


def save_encoder(model: DenoiseAE, encoder_name: str, out: Path) -> Tuple[Path, int]:
    """Write the encoder's weights as an encoder npz; (path, arrays)."""
    flat = encoder_to_flax(model.state_dict())
    save_encoder_npz(out, flat, {"encoder_name": encoder_name, **META})
    return Path(out), len(flat)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--encoder", default="resnet18", choices=sorted(_RESNET_STAGES))
    parser.add_argument("--steps", type=int, default=500)
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--size", type=int, default=64)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", type=Path, default=None)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    model, _ = pretrain(args.encoder, args.steps, args.batch, args.size, args.seed, args.device)
    out, n = save_encoder(model, args.encoder, args.out or default_weights_path(args.encoder))
    print(f"Wrote encoder ({n} arrays) to {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
