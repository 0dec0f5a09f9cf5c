"""No module of JAX or of the JAX package in a run, compared by whole
top-level names (the port's name begins with the JAX package's); nothing
of the program in the reference."""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = ("jax", "jaxlib", "flax", "cosmology_gnn_simulation_tpu")


def loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, check=True, timeout=300)
    return set(out.stdout.split())


def test_harness_and_reference_load_no_jax():
    tops = loaded("import portbench.harness, portbench.control, portbench.tracing\n"
                  "import portbench.reference.knn, portbench.reference.featurize\n"
                  "import portbench.reference.model, portbench.reference.integrate\n"
                  "import portbench.reference.train, portbench.reference.weights\n"
                  "import portbench.entries.rollout, portbench.entries.train_step\n"
                  "import cosmology_gnn_simulation_tpu_torch.rollout\n"
                  "import cosmology_gnn_simulation_tpu_torch.training\n")
    assert "cosmology_gnn_simulation_tpu_torch" in tops
    assert not tops & set(FORBIDDEN), tops & set(FORBIDDEN)


def test_reference_loads_nothing_of_the_program():
    tops = loaded("import portbench.reference.integrate, portbench.reference.train\n")
    assert "torch" in tops
    assert not tops & set(FORBIDDEN + ("cosmology_gnn_simulation_tpu_torch",))


def test_the_check_compares_whole_names(monkeypatch):
    from portbench import harness
    monkeypatch.setitem(sys.modules, "cosmology_gnn_simulation_tpu_torch_x", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", sys)
    assert harness.forbidden_modules() == ["jaxlib"]
