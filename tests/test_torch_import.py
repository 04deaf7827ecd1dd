"""The PyTorch port imports without jax, flax, optax or orbax, and without
scikit-learn or matplotlib, which the machine with the card lacks."""

import os
import subprocess
import sys


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "gcnbmp_tpu_torch")

MODULES = [
    "gcnbmp_tpu_torch",
    "gcnbmp_tpu_torch.data.wire",
    "gcnbmp_tpu_torch.ops.aggregate",
    "gcnbmp_tpu_torch.ops.circular",
    "gcnbmp_tpu_torch.ops.fused_ggnn",
    "gcnbmp_tpu_torch.ops.fused_mpnn",
    "gcnbmp_tpu_torch.ops.set2set_kernel",
    "gcnbmp_tpu_torch.ops.slotgather",
    "gcnbmp_tpu_torch.ops.build",
    "gcnbmp_tpu_torch.models.layers",
    "gcnbmp_tpu_torch.models.ggnn",
    "gcnbmp_tpu_torch.models.heads",
    "gcnbmp_tpu_torch.models.packed",
    "gcnbmp_tpu_torch.convert",
    "gcnbmp_tpu_torch.eval.evaluate",
    "gcnbmp_tpu_torch.cli.predict",
    "gcnbmp_tpu_torch.train.config",
    "gcnbmp_tpu_torch.train.schedules",
    "gcnbmp_tpu_torch.train.metrics",
    "gcnbmp_tpu_torch.train.loop",
    "gcnbmp_tpu_torch.train.checkpoints",
    "gcnbmp_tpu_torch.cli.train",
]

BLOCKER = """
import importlib.abc, sys
class Blocker(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax",
                                  "sklearn", "matplotlib"):
            raise ImportError("blocked: " + name)
for m in [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax")]:
    del sys.modules[m]
sys.meta_path.insert(0, Blocker())
"""


def test_port_imports_with_jax_blocked():
    code = BLOCKER + "".join(f"import {m}\n" for m in MODULES) + (
        "from gcnbmp_tpu_torch.cli.predict import main\n"
        "from gcnbmp_tpu_torch.cli.train import main\n"
        "assert not [m for m in sys.modules if m.startswith('jax')]\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_no_jax_in_port_sources():
    words = ("import jax", "from jax", "import flax", "from flax",
             "import optax", "from optax", "import orbax", "from orbax")
    for dirpath, _, files in os.walk(PKG):
        for name in files:
            if name.endswith((".py", ".cu")):
                with open(os.path.join(dirpath, name)) as f:
                    src = f.read()
                for word in words:
                    assert word not in src, (word, os.path.join(dirpath, name))
