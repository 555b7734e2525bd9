"""The port stands alone: every module of py4cast_tpu_torch, its example
plugin (py4cast_tpu_torch_plugin_example.py) and chip_smoke.py import
with JAX and the JAX package blocked, and with xarray, cfgrib, zarr and
cartopy blocked too (imported only inside the functions that need
them), and no source imports from py4cast_tpu."""

import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "py4cast_tpu_torch"

_BLOCKED_IMPORT = """
import importlib, pkgutil, sys
# the JAX side, and the optional packages that only the functions needing
# them import (grib reading, zarr conversion, map projections)
for name in ("jax", "jaxlib", "flax", "optax", "orbax", "py4cast_tpu",
             "xarray", "cfgrib", "zarr", "cartopy"):
    sys.modules[name] = None  # any import of these now raises ImportError
import py4cast_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(py4cast_tpu_torch.__path__, "py4cast_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
import chip_smoke
import py4cast_tpu_torch_plugin_example
import py4cast_tpu_torch.models as models
assert models.registry["Identity"] is py4cast_tpu_torch_plugin_example.Identity
loaded = sorted(k for k in sys.modules if k.split(".")[0] in ("jax", "flax", "py4cast_tpu")
                and sys.modules[k] is not None)
assert not loaded, loaded
print(len(mods))
"""


def test_port_imports_without_jax():
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORT], cwd=ROOT, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip().splitlines()[-1]) >= 15


_TOOLS_IMPORT = """
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "flax", "optax", "orbax", "py4cast_tpu"):
    sys.modules[name] = None
import py4cast_tpu_torch
mods = {m.name for m in pkgutil.walk_packages(py4cast_tpu_torch.__path__, "py4cast_tpu_torch.")}
tools = {"py4cast_tpu_torch.export", "py4cast_tpu_torch.ops.flops", "py4cast_tpu_torch.tools",
         "py4cast_tpu_torch.tools.scores_comparison", "py4cast_tpu_torch.tools.gif_comparison",
         "py4cast_tpu_torch.tools.pretrain_encoder",
         "py4cast_tpu_torch.tools.train_perceptual_features",
         "py4cast_tpu_torch.tools.convert_torchvision_encoder",
         "py4cast_tpu_torch.tools.make_grib_template",
         "py4cast_tpu_torch.tools.host_memory_check"}
assert tools <= mods, sorted(tools - mods)
for m in sorted(tools):
    importlib.import_module(m)
loaded = sorted(k for k in sys.modules if k.split(".")[0] in ("jax", "flax", "optax", "orbax",
                                                              "py4cast_tpu")
                and sys.modules[k] is not None)
assert not loaded, loaded
"""


def test_user_tools_are_walked_and_import_without_jax():
    """export.py, ops/flops.py and the tools package with its seven tools
    are among the modules the walk reaches, and import with JAX, flax,
    optax, orbax and the JAX package blocked."""
    out = subprocess.run([sys.executable, "-c", _TOOLS_IMPORT], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr


_OBSERVERS_IMPORT = """
import sys
for name in ("jax", "jaxlib", "flax", "optax", "orbax", "py4cast_tpu", "matplotlib"):
    sys.modules[name] = None
import pkgutil
import py4cast_tpu_torch.io
io_mods = sorted(m.name for m in pkgutil.walk_packages(py4cast_tpu_torch.io.__path__,
                                                      "py4cast_tpu_torch.io."))
assert io_mods == ["py4cast_tpu_torch.io.grib2", "py4cast_tpu_torch.io.outputs"], io_mods
import py4cast_tpu_torch.io.grib2, py4cast_tpu_torch.io.outputs
import py4cast_tpu_torch.metrics, py4cast_tpu_torch.plots, py4cast_tpu_torch.training
import py4cast_tpu_torch.cli
from py4cast_tpu_torch.plots import can_draw
assert not can_draw()
"""


def test_io_metrics_and_plots_import_without_jax_or_matplotlib():
    """The io subpackage (grib2, outputs), metrics, plots, the trainer and
    the CLI import with JAX, the JAX package and matplotlib blocked:
    matplotlib is imported only by the functions that draw."""
    out = subprocess.run([sys.executable, "-c", _OBSERVERS_IMPORT], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_no_source_imports_the_jax_package():
    pattern = re.compile(r"^\s*(from|import)\s+(py4cast_tpu(\.|\s|$)|jax\b|flax\b|optax\b|orbax\b)",
                         re.MULTILINE)
    offenders = [
        str(p.relative_to(ROOT))
        for p in list(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                             ROOT / "py4cast_tpu_torch_plugin_example.py"]
        if pattern.search(p.read_text())
    ]
    assert offenders == []


def test_importing_the_port_builds_nothing():
    """Import must not build or load a CUDA library: the kernels build at
    their first launch on a CUDA tensor (or by chip_smoke.py); nor the
    npy batch reader, which builds at its first read."""
    code = (
        "import py4cast_tpu_torch.models, py4cast_tpu_torch.training\n"
        "import py4cast_tpu_torch.datasets, py4cast_tpu_torch.datasets.dataset_cli\n"
        "from py4cast_tpu_torch import native\n"
        "from py4cast_tpu_torch.ops import _build\n"
        "assert _build._LIBS == {}, _build._LIBS\n"
        "assert native._LIB is None\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_chip_smoke_graphlam_args_match_the_config():
    import yaml

    sys.path.insert(0, str(ROOT))
    import chip_smoke

    conf = yaml.safe_load((ROOT / "config/CLI/model/graphlam.yaml").read_text())
    assert chip_smoke.GRAPHLAM_ARGS == conf["model"]["settings_init_args"]


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    """Without CUDA the script exits non-zero and prints no result line."""
    import torch

    if torch.cuda.is_available():
        import pytest

        pytest.skip("this host has a CUDA device")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_segformer_args_match_the_config():
    import yaml

    sys.path.insert(0, str(ROOT))
    import chip_smoke

    conf = yaml.safe_load((ROOT / "config/CLI/model/segformer.yaml").read_text())
    assert chip_smoke.SEGFORMER_ARGS == conf["model"]["settings_init_args"]


def test_chip_smoke_swinunetr_args_match_the_config():
    import yaml

    sys.path.insert(0, str(ROOT))
    import chip_smoke

    conf = yaml.safe_load((ROOT / "config/CLI/model/swinunetr.yaml").read_text())
    assert chip_smoke.SWINUNETR_ARGS == conf["model"]["settings_init_args"]


def test_ptxas_summary_reads_every_instance():
    """chip_smoke.ptxas_summary pairs each instance of a kernel template
    with its registers and spills, and skips other kernels."""
    import chip_smoke

    text = """ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_119stencil_message_bwdILi64EEEvNS_4ArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_119stencil_message_bwdILi64EEEvNS_4ArgsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 194 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN3p4t12sum_partialsEPKfPfii' for 'sm_90a'
ptxas info    : Function properties for _ZN3p4t12sum_partialsEPKfPfii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 32 registers, used 0 barriers
ptxas info    : Compiling entry function '_ZN3p4t8attn_fwd22short_kv_attention_fwdILi2ELi1ELi8EEEvv' for 'sm_90a'
ptxas info    : Function properties for _ZN3p4t8attn_fwd22short_kv_attention_fwdILi2ELi1ELi8EEEvv
    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN50_GLOBAL__N__3ab277fc_17_corner_hop_bwd_cu_9cff1b4f21corner_hop_bwd_cornerILi32EEEvNS_4ArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN50_GLOBAL__N__3ab277fc_17_corner_hop_bwd_cu_9cff1b4f21corner_hop_bwd_cornerILi32EEEvNS_4ArgsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN50_GLOBAL__N__3ab277fc_17_corner_hop_bwd_cu_9cff1b4f19corner_hop_bwd_nodeILi64EEEvNS_4ArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN50_GLOBAL__N__3ab277fc_17_corner_hop_bwd_cu_9cff1b4f19corner_hop_bwd_nodeILi64EEEvNS_4ArgsE
    0 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN50_GLOBAL__N__5e1b0c2a_13_corner_hop_cu_8f0d2c3e14corner_hop_fwdILi64EEEvNS_4ArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN50_GLOBAL__N__5e1b0c2a_13_corner_hop_cu_8f0d2c3e14corner_hop_fwdILi64EEEvNS_4ArgsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 167 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN50_GLOBAL__N__5e1b0c2a_13_corner_hop_cu_8f0d2c3e20corner_hop_fwd_warpsILi3ELi2EEEvNS_4ArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN50_GLOBAL__N__5e1b0c2a_13_corner_hop_cu_8f0d2c3e20corner_hop_fwd_warpsILi3ELi2EEEvNS_4ArgsE
    24 bytes stack frame, 20 bytes spill stores, 28 bytes spill loads
ptxas info    : Used 80 registers, used 1 barriers
"""
    assert chip_smoke.ptxas_summary(text, "stencil_message_bwd") == [("64", 194, (0, 0))]
    assert chip_smoke.ptxas_summary(text, "short_kv_attention_fwd") == [("2,1,8", 128, (4, 12))]
    # the corner-hop backward's two passes, each by its own name
    assert chip_smoke.ptxas_summary(text, "corner_hop_bwd_node") == [("64", 255, (8, 8))]
    assert chip_smoke.ptxas_summary(text, "corner_hop_bwd_corner") == [("32", 168, (0, 0))]
    assert chip_smoke.ptxas_summary(text, "corner_hop_bwd") == []
    # the corner-hop forward's row-tile and warp-row kernels, apart
    assert chip_smoke.ptxas_summary(text, "corner_hop_fwd") == [("64", 167, (0, 0))]
    assert chip_smoke.ptxas_summary(text, "corner_hop_fwd_warps") == [("3,2", 80, (20, 28))]
