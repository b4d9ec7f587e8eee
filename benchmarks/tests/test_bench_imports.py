"""The import check: no module of JAX or of the JAX package in a process
that runs the benchmark, compared by whole top-level names."""

import subprocess
import sys

from benchmarks import harness


def test_top_level_names_compared_whole():
    names = ["alphazero_risk_tpu_torch", "alphazero_risk_tpu_torch.kernels",
             "jax_extra", "jaxline", "flaxen", "torch", "benchmarks.run"]
    assert harness.forbidden_loaded(names) == []
    bad = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "optax",
           "alphazero_risk_tpu", "alphazero_risk_tpu.env.rules"]
    assert harness.forbidden_loaded(bad + names) == sorted(bad)


def test_benchmark_process_loads_no_jax():
    """Every module the harness, the drivers, the metrics and the
    reference load, with the program modules the drivers call, in a fresh
    process."""
    code = """
import sys
sys.path.insert(0, %r)
from benchmarks import harness
from benchmarks.reference import play, params
spec = harness.load_spec()
for w in spec["workloads"]:
    cell = harness.Cell(spec, w["name"])
    harness.driver(cell)
    for m in cell.per_layer:
        harness.load_file(cell.metric_files[m["name"]], "m_" + m["name"])
import alphazero_risk_tpu_torch.training.trainer
import alphazero_risk_tpu_torch.kernels
print(",".join(harness.forbidden_loaded()))
""" % str(harness.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""
