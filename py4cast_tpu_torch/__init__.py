"""py4cast_tpu_torch — the PyTorch/CUDA port of py4cast_tpu.

Plain tensor code is PyTorch; every Pallas kernel of the JAX package on
a ported path is a CUDA C++ kernel written by hand for Hopper
(``csrc/``), built with ``nvcc`` at first use on a CUDA device and
bound through ``ctypes`` (``ops/_build.py``). Importing the package
builds and loads nothing CUDA-only.

The port imports neither JAX nor anything of ``py4cast_tpu``: it keeps
its own copy of every numpy helper it needs.
"""

__version__ = "0.1.0"

from py4cast_tpu_torch.named_tensor import NamedArray  # noqa: F401
