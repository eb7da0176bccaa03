"""The port stands alone: no module of kinpoly_tpu_torch, and not
chip_smoke.py, imports JAX, its libraries, the host-only packages the card
lacks, or the JAX package."""

import ast
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "joblib", "yaml", "mujoco",
             "kinpoly_tpu")
FILES = sorted((ROOT / "kinpoly_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_sources_import_nothing_forbidden():
    assert len(FILES) > 20
    for path in FILES:
        bad = _imported_roots(path) & set(FORBIDDEN)
        assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


_BLOCKED_IMPORT = r"""
import importlib, importlib.abc, importlib.util, pkgutil, sys
FORBIDDEN = set(sys.argv[1].split(","))

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in FORBIDDEN:
            raise ImportError(f"blocked: {name}")
        return None

sys.meta_path.insert(0, Block())
import kinpoly_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(kinpoly_tpu_torch.__path__,
                                              "kinpoly_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
loaded = sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)
assert not loaded, loaded
print(len(mods))
"""


def test_modules_import_with_forbidden_blocked():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORT, ",".join(FORBIDDEN)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert int(proc.stdout.split()[-1]) > 20


def test_ar_training_modules_are_covered():
    """The AR-training modules are among the files scanned above and the
    modules imported with the forbidden packages blocked."""
    for mod in ("utils/liveness.py", "rl/optim.py", "rl/agent_ar.py",
                "scripts/train_ar_policy.py", "scripts/exp_arnet.py"):
        assert ROOT / "kinpoly_tpu_torch" / mod in FILES, mod


def test_data_path_modules_are_covered():
    """The data path's modules (parsers, SMPL and AMASS, grounding, the
    viewer) are among the files scanned above."""
    for mod in ("anim/stl.py", "anim/mjcf.py", "anim/smpl.py", "data/amass.py",
                "data/amass_dataset.py", "data/ground_fix.py",
                "utils/html_viewer.py", "scripts/view_motion.py"):
        assert ROOT / "kinpoly_tpu_torch" / mod in FILES, mod


def test_zoo_modules_are_covered():
    """The rest of anim and tmath, the model zoo with its RNN and the
    reference state-dict loader, TRPO and A2C, and the host utilities are
    among the files scanned above."""
    for mod in ("core/tmath.py", "anim/smpl_model.py", "anim/bvh.py",
                "anim/retarget.py", "anim/occupancy.py", "models/rnn.py",
                "models/aux_nets.py", "models/weights.py",
                "models/torch_import.py", "rl/trpo.py", "rl/a2c.py",
                "utils/profiling.py", "utils/flags.py", "utils/native.py"):
        assert ROOT / "kinpoly_tpu_torch" / mod in FILES, mod
