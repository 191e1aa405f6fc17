"""The port stands alone: ``repro_torch`` imports neither JAX nor the JAX
package, neither at run time nor anywhere in its sources."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)", re.MULTILINE)

CHECK = (
    "import repro_torch, repro_torch.core, repro_torch.sparse, "
    "repro_torch.kernels.build, repro_torch.kernels.sptrsv_level.ops, "
    "repro_torch.kernels.sptrsv_fused.ops, repro_torch.kernels.spmv_ell.ops, "
    "repro_torch.kernels.trsm_block.ops, repro_torch.core.rewrite, "
    "repro_torch.kernels.flash_attn.ops, repro_torch.models, "
    "repro_torch.models.convert, repro_torch.configs, "
    "repro_torch.configs.granite_3_8b, repro_torch.serve, "
    "repro_torch.launch.serve, repro_torch.core.pcg, repro_torch.core.guard, "
    "repro_torch.core.sweep, repro_torch.core.calibrate, "
    "repro_torch.bench.calibrate, repro_torch.serve.engine, "
    "repro_torch.serve.registry, repro_torch.serve.service, "
    "repro_torch.serve.metrics, repro_torch.bench.common, "
    "repro_torch.bench.serve_bench, repro_torch.bench.fig6_levels, "
    "repro_torch.bench.exp1_codegen, repro_torch.bench.exp2_rewrite, "
    "repro_torch.bench.refresh, repro_torch.bench.batch_solve, "
    "repro_torch.bench.coarsen, repro_torch.bench.blocked, "
    "repro_torch.bench.sweep, repro_torch.bench.guard, "
    "repro_torch.bench.preconditioner, repro_torch.bench.rewrite_planner, "
    "repro_torch.core.recurrence, repro_torch.core.dist, "
    "repro_torch.launch.mesh, repro_torch.bench.dist_solve, "
    "repro_torch.bench.lm_step, repro_torch.models.moe, "
    "repro_torch.configs.llama4_scout_17b_a16e, repro_torch.configs.arctic_480b, "
    "repro_torch.configs.xlstm_350m, repro_torch.configs.whisper_medium, "
    "repro_torch.configs.paligemma_3b, sys; "
    "from repro_torch.serve import (ServeEngine, Request, SolveEngine, "
    "SolveRequest, SolverRegistry, SolverEntry, pattern_key, SolveService, "
    "TenantState, LatencyHistogram); "
    "bad = [m for m in sys.modules if m == 'jax' or m == 'repro' "
    "or m.startswith(('jax.', 'repro.'))]; "
    "assert not bad, bad"
)


def test_import_pulls_in_no_jax_and_no_repro():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", CHECK], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PKG)))
def test_sources_do_not_import_jax_or_repro(path):
    hits = FORBIDDEN.findall(path.read_text())
    assert not hits, f"{path} imports {hits}"


def test_scan_catches_forbidden_imports():
    for line in ("import jax", "from jax import numpy", "import repro",
                 "from repro.core import SpTRSV", "  import jax.numpy as jnp"):
        assert FORBIDDEN.search(line), line
    for line in ("import repro_torch", "from repro_torch.core import x",
                 "import jaxlib_free", "# from repro import nothing"):
        assert not FORBIDDEN.search(line), line
