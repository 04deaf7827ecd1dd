"""The PyTorch port imports without jax, flax, optax or orbax, without the
JAX package ``gcnbmp_tpu`` itself, and without scikit-learn or matplotlib,
which the machine with the card lacks."""

import os
import subprocess
import sys


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "gcnbmp_tpu_torch")
CHIP_SCRIPTS = [os.path.join(ROOT, name)
                for name in ("chip_smoke.py", "chip_phases.py",
                             "chip_quality.py", "chip_multi_device.py")]

MODULES = [
    "gcnbmp_tpu_torch",
    "gcnbmp_tpu_torch.native_lib",
    "gcnbmp_tpu_torch.chem",
    "gcnbmp_tpu_torch.chem.mol",
    "gcnbmp_tpu_torch.chem.smiles",
    "gcnbmp_tpu_torch.chem.featurize",
    "gcnbmp_tpu_torch.chem.native",
    "gcnbmp_tpu_torch.data",
    "gcnbmp_tpu_torch.data.dataset",
    "gcnbmp_tpu_torch.data.parsers",
    "gcnbmp_tpu_torch.data.packing",
    "gcnbmp_tpu_torch.data.native_pack",
    "gcnbmp_tpu_torch.data.wire",
    "gcnbmp_tpu_torch.data.prefetch",
    "gcnbmp_tpu_torch.data.splits",
    "gcnbmp_tpu_torch.data.synth",
    "gcnbmp_tpu_torch.ops.aggregate",
    "gcnbmp_tpu_torch.ops.circular",
    "gcnbmp_tpu_torch.ops.fused_ggnn",
    "gcnbmp_tpu_torch.ops.fused_mpnn",
    "gcnbmp_tpu_torch.ops.set2set_kernel",
    "gcnbmp_tpu_torch.ops.slotgather",
    "gcnbmp_tpu_torch.ops.build",
    "gcnbmp_tpu_torch.models.layers",
    "gcnbmp_tpu_torch.models.ggnn",
    "gcnbmp_tpu_torch.models.ggnn_extras",
    "gcnbmp_tpu_torch.models.ggnn_dev",
    "gcnbmp_tpu_torch.models.relgcn",
    "gcnbmp_tpu_torch.models.gin",
    "gcnbmp_tpu_torch.models.nfp",
    "gcnbmp_tpu_torch.models.heads",
    "gcnbmp_tpu_torch.models.packed",
    "gcnbmp_tpu_torch.models.gwm",
    "gcnbmp_tpu_torch.models.readouts",
    "gcnbmp_tpu_torch.models.mpnn",
    "gcnbmp_tpu_torch.models.predictor",
    "gcnbmp_tpu_torch.models",
    "gcnbmp_tpu_torch.entry",
    "gcnbmp_tpu_torch.convert",
    "gcnbmp_tpu_torch.eval.evaluate",
    "gcnbmp_tpu_torch.cli.predict",
    "gcnbmp_tpu_torch.train.config",
    "gcnbmp_tpu_torch.train.schedules",
    "gcnbmp_tpu_torch.train.metrics",
    "gcnbmp_tpu_torch.train.loop",
    "gcnbmp_tpu_torch.train.checkpoints",
    "gcnbmp_tpu_torch.cli.train",
    "gcnbmp_tpu_torch.cli.evaluate",
    "gcnbmp_tpu_torch.cli.data_generator",
    "gcnbmp_tpu_torch.chem.mol2vec",
    "gcnbmp_tpu_torch.chem.transforms",
    "gcnbmp_tpu_torch.models.gae",
    "gcnbmp_tpu_torch.train.fixed",
    "gcnbmp_tpu_torch.eval.saliency",
    "gcnbmp_tpu_torch.eval.baselines",
    "gcnbmp_tpu_torch.parallel",
    "gcnbmp_tpu_torch.parallel.mesh",
    "gcnbmp_tpu_torch.parallel.collectives",
    "gcnbmp_tpu_torch.parallel.dp",
    "gcnbmp_tpu_torch.parallel.edgeshard",
    "gcnbmp_tpu_torch.parallel.multihost",
    "gcnbmp_tpu_torch.parallel.multihost_demo",
]

BLOCKER = """
import importlib.abc, sys
class Blocker(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax",
                                  "sklearn", "matplotlib", "gcnbmp_tpu"):
            raise ImportError("blocked: " + name)
for m in [m for m in sys.modules
          if m.split(".")[0] in ("jax", "jaxlib", "flax", "gcnbmp_tpu")]:
    del sys.modules[m]
sys.meta_path.insert(0, Blocker())
"""


def test_port_imports_with_jax_blocked():
    code = BLOCKER + "".join(f"import {m}\n" for m in MODULES) + (
        "from gcnbmp_tpu_torch.cli.predict import main\n"
        "from gcnbmp_tpu_torch.cli.train import main\n"
        "sys.path.insert(0, '.')\n"
        "import chip_quality\n"
        "assert not [m for m in sys.modules if m.startswith('jax')\n"
        "            or m.split('.')[0] == 'gcnbmp_tpu']\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_no_jax_in_port_sources():
    words = ("import jax", "from jax", "import flax", "from flax",
             "import optax", "from optax", "import orbax", "from orbax",
             "from gcnbmp_tpu.", "import gcnbmp_tpu.", "from gcnbmp_tpu import",
             "import gcnbmp_tpu\n")
    paths = CHIP_SCRIPTS + [
        os.path.join(dirpath, name) for dirpath, _, files in os.walk(PKG)
        for name in files if name.endswith((".py", ".cu", ".cuh"))]
    for path in paths:
        with open(path) as f:
            src = f.read()
        for word in words:
            assert word not in src, (word, path)
