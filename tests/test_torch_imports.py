"""The port and chip_smoke.py import nothing of JAX and nothing of the JAX package."""

import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

GUARD = r"""
import importlib.abc, sys
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "video_diffusion_nnx_tpu")

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import of {name}")
        return None

for name in list(sys.modules):
    if name.split(".")[0] in BLOCKED:
        del sys.modules[name]
sys.meta_path.insert(0, Block())
sys.path.insert(0, sys.argv[1])

import importlib, importlib.util, pkgutil
import video_diffusion_nnx_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1] + "/chip_smoke.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
assert not any(n.split(".")[0] in BLOCKED for n in sys.modules), "a blocked module was imported"
print("imported", len(names), "modules:", " ".join(names))
"""


def test_port_and_chip_smoke_import_without_jax():
    proc = subprocess.run(
        [sys.executable, "-c", GUARD, str(REPO)],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env={**os.environ, "OMP_NUM_THREADS": "1"},
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "imported" in proc.stdout
    for name in ("parallel", "parallel.mesh", "parallel.sequence", "parallel.sharding", "ops.cross_attention",
                 "models.dit", "training.distill", "training.guidance", "distill", "distill_guidance",
                 "eval_bouncing_digits_distilled", "sample", "extend", "serve", "train"):
        assert f" video_diffusion_nnx_tpu_torch.{name} " in proc.stdout + " ", name


def test_every_kernel_source_is_built_and_counted():
    """Each csrc/*.cu is in the build list of ops/_build.py, and each launch counter belongs to a kernel chip_smoke.py names."""
    import importlib.util

    from video_diffusion_nnx_tpu_torch import ops
    from video_diffusion_nnx_tpu_torch.ops import _build

    assert {p.stem for p in _build.CSRC.glob("*.cu")} == set(_build.SOURCES)
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert set(ops.launch_counts()) == set(smoke.KERNELS)
    for meta in smoke.KERNELS.values():
        assert (REPO / meta["source"]).is_file()
        path, line = meta["replaces"].split(" ")[0].rsplit(":", 1)
        assert "pallas" in (REPO / path).read_text() and int(line) > 0
