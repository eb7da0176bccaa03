"""The frozen counts reproduce the kernel bounds the port's records give
at 2048 envs, and nothing the benchmark runs imports JAX or the JAX
package; the reference imports nothing of the port."""

import ast
import subprocess
import sys

import pytest

from harness import counts, spec

BENCH = spec.BENCH_DIR


@pytest.mark.parametrize("what, ms", [
    (lambda: counts.ltdl_factor(2048, counts.DEPTH), 0.00597),
    (lambda: counts.ltdl_solve(2048, counts.DEPTH, 55), 0.0232),
    (lambda: counts.ltdl_solve(2048, counts.DEPTH, 49), 0.0210),
    (lambda: counts.ltdl_solve(2048, counts.DEPTH, 1), 0.00335),
    (lambda: counts.pgs_solve(2048, 18, 20), 0.0080),
    (lambda: counts.pgs_solve(2048, 24, 20), 0.0138),
])
def test_kernel_bounds_at_2048(what, ms):
    assert round(counts.bound_s(*what()) * 1e3, 5) == pytest.approx(ms, abs=6e-5)


def test_depths_are_the_reference_humanoids():
    import torch
    from refimpl.anim.spec import synthetic_spec
    from refimpl.config.defaults import uhc_control_params
    from refimpl.physics import engine as eng
    s = synthetic_spec()
    m = eng.build_model(s, uhc_control_params(s), device="cpu",
                        dtype=torch.float64)
    assert list(map(int, m.topo.depth)) == counts.DEPTH
    assert m.contact_iters == 20 and m.n_substeps == 15


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for n in ast.walk(tree):
        if isinstance(n, ast.Import):
            yield from (a.name for a in n.names)
        elif isinstance(n, ast.ImportFrom) and n.module and n.level == 0:
            yield n.module


FILES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)
REFERENCE = [p for p in FILES if "refimpl" in p.parts
             or p.name.startswith("ref_")]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_import(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & {"jax", "jaxlib", "flax", "optax", "kinpoly_tpu"}


@pytest.mark.parametrize("path", REFERENCE,
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_reference_imports_nothing_of_the_port(path):
    assert "kinpoly_tpu_torch" not in {m.split(".")[0] for m in _imports(path)}


def test_no_jax_loaded_at_run_time():
    """Importing the harness, every loop and the reference loads no module
    of JAX or of the JAX package (whole top-level names)."""
    code = ("import sys; sys.path[:0] = [%r, %r]\n"
            "import harness.cli, harness.loops.uhc_train, harness.ref_uhc\n"
            "import kinpoly_tpu_torch.scripts.train_uhc\n"
            "print(harness.cli.forbidden_modules())"
            % (str(BENCH), str(BENCH.parent)))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "[]"
