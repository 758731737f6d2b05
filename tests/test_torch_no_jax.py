"""The PyTorch port imports no JAX, not even indirectly: in a fresh
interpreter, import the port and run a tiny registration, then check
``sys.modules``."""
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

SCRIPT = """
import sys
import torch
import deformationpyramid_tpu_torch as dp
from deformationpyramid_tpu_torch.data.synthetic import make_pair
from deformationpyramid_tpu_torch.solve import loop, registration
from deformationpyramid_tpu_torch.ops import chamfer, cuda_lib, fused_iteration, knn
from deformationpyramid_tpu_torch.metrics import flow
from deformationpyramid_tpu_torch.data import ply
from deformationpyramid_tpu_torch.cli import shape_transfer

src, tgt, _ = make_pair(n=120, seed=0)
for fused in (False, True):
    cfg = dp.SolverConfig(pyramid=dp.NDPConfig(m=2, width=16), iters=5,
                          samples=80, use_fused_iteration=fused)
    warped, stats = dp.register_pair(0, torch.from_numpy(src),
                                     torch.from_numpy(tgt), cfg)
    assert torch.isfinite(warped).all()
for w_cd in (0.0, 1.0):
    cfg = dp.SolverConfig(pyramid=dp.NDPConfig(m=2, width=16), iters=5,
                          samples=80, w_cd=w_cd, use_fused_iteration=True,
                          use_fused_ldmk=True)
    s = torch.from_numpy(src)
    warped, _ = dp.register_pair(0, s, torch.from_numpy(tgt), cfg,
                                 src_ldmk=s[:20], tgt_ldmk=s[:20] + 0.01)
    assert torch.isfinite(warped).all()
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m.startswith("jaxlib") or m.startswith("deformationpyramid_tpu."))
print("JAX_MODULES", bad)
assert not bad, bad
"""


def test_port_imports_no_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "JAX_MODULES []" in proc.stdout
